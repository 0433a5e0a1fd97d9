"""Instrumented locks (the port's own copy of
``predictionio_tpu/concurrency/locks.py``): lock discipline verified
live. Every lock of the serving stack (``server/``, ``cache/``,
``rollout/``) is created through :func:`new_lock` / :func:`new_rlock`:

- **Disabled** (the default): the factory returns a plain
  ``threading.Lock`` / ``threading.RLock``, the stdlib object itself,
  so the hot path carries no instrumentation (a test asserts the type).
- **Enabled** (``ServerConfig.debug_locks``, ``deploy --debug-locks`` or
  ``PTPU_DEBUG_LOCKS=1``): the factory returns a :class:`DebugLock` that
  feeds one process-wide :class:`LockRegistry`:

  * the **acquisition-order graph**: acquiring B while holding A adds
    edge A->B; if the graph already proves B->...->A, that is a
    lock-order inversion (two threads interleaving those paths
    deadlock) and it is recorded with its sites;
  * **same-thread re-entry** on a non-reentrant lock raises at once,
    where the plain lock would hang for ever;
  * **hold-time and wait-time histograms** plus contention counters,
    exported as ``pio_lock_*`` metrics by :func:`register_lock_metrics`;
  * a **deadlock watchdog**: any single lock wait past
    ``PTPU_LOCK_WATCHDOG_SEC`` (default 5 s) dumps every thread's stack
    to the access log.

The flag is read when a lock is made: switch it on before the server
whose locks it should cover is built.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Set, Tuple

log = logging.getLogger(__name__)

__all__ = [
    "DebugLock",
    "LockRegistry",
    "instrument_locks",
    "lock_registry",
    "locks_instrumented",
    "new_lock",
    "new_rlock",
    "register_lock_metrics",
    "watchdog_threshold_sec",
]


def _env_enabled() -> bool:
    return os.environ.get("PTPU_DEBUG_LOCKS", "").strip().lower() in (
        "1", "true", "yes", "on")


_enabled = _env_enabled()


def instrument_locks(on: bool = True) -> None:
    """Globally switch the lock factories to (or from) debug mode.
    Only locks created AFTER the switch are instrumented — flip it
    before building the server (``ServerConfig.debug_locks`` does)."""
    global _enabled
    _enabled = bool(on)


def locks_instrumented() -> bool:
    return _enabled


def watchdog_threshold_sec() -> float:
    """Seconds a single lock wait may last before the watchdog dumps
    all thread stacks to the access log."""
    try:
        return max(float(os.environ.get("PTPU_LOCK_WATCHDOG_SEC", 5.0)),
                   0.05)
    except ValueError:
        return 5.0


# ---------------------------------------------------------------------------
# the process-wide registry
# ---------------------------------------------------------------------------

class LockRegistry:
    """Acquisition-order graph + contention/hold telemetry.

    One per process (:func:`lock_registry`); every :class:`DebugLock`
    reports here. Its own mutex is a plain ``threading.Lock`` held only
    for dict updates — it is deliberately NOT a DebugLock (the
    instrument must not observe itself).
    """

    def __init__(self) -> None:
        self._mutex = threading.Lock()
        #: held-lock name → names acquired while holding it
        self._edges: Dict[str, Set[str]] = {}
        #: (held, acquired) → first-seen "path:line" site
        self._edge_sites: Dict[Tuple[str, str], str] = {}
        self._inversions: List[dict] = []
        self._reported_pairs: Set[Tuple[str, str]] = set()
        self._reentries: List[dict] = []
        self._acquisitions = 0
        self._contended = 0
        self._watchdog_dumps = 0
        self._wait_hist: Dict[str, Any] = {}
        self._hold_hist: Dict[str, Any] = {}
        self._contention_by_lock: Dict[str, int] = {}
        #: thread id → stack of lock names it currently holds
        self._held: Dict[int, List[str]] = {}

    # -- histograms (lazy: obs import stays off the disabled path) ----------
    def _hist(self, table: Dict[str, Any], name: str) -> Any:
        h = table.get(name)
        if h is None:
            from ..obs.histogram import (
                DEFAULT_LATENCY_BOUNDS,
                StreamingHistogram,
            )
            h = table[name] = StreamingHistogram(DEFAULT_LATENCY_BOUNDS)
        return h

    # -- graph ---------------------------------------------------------------
    def _path_exists(self, src: str, dst: str) -> bool:
        """Is there a directed path src → … → dst in the order graph?"""
        seen = {src}
        frontier = [src]
        while frontier:
            nxt = frontier.pop()
            for n in self._edges.get(nxt, ()):
                if n == dst:
                    return True
                if n not in seen:
                    seen.add(n)
                    frontier.append(n)
        return False

    def note_acquire_attempt(self, name: str, held: List[str],
                             site: str) -> None:
        """Record order edges held→name; detect inversions BEFORE the
        caller blocks (a live deadlock would otherwise hide the
        report)."""
        with self._mutex:
            self._acquisitions += 1
            for h in held:
                if h == name:
                    continue
                self._edges.setdefault(h, set()).add(name)
                self._edge_sites.setdefault((h, name), site)
                # one report per cyclic pair, whichever direction
                # trips it first ({A,B} is one deadlock, not two)
                pair = (name, h) if name < h else (h, name)
                # inversion: the graph already proves name → … → h,
                # and this thread now wants name while holding h
                if pair not in self._reported_pairs \
                        and self._path_exists(name, h):
                    self._reported_pairs.add(pair)
                    inv = {
                        "held": h,
                        "acquiring": name,
                        "site": site,
                        "prior_site": self._edge_sites.get(
                            (name, h), "?"),
                        "thread": threading.current_thread().name,
                    }
                    self._inversions.append(inv)
                    log.error(
                        "lock-order inversion: thread %r acquiring %r "
                        "while holding %r at %s, but %r → %r was "
                        "established at %s",
                        inv["thread"], name, h, site, name, h,
                        inv["prior_site"])

    def note_acquired(self, name: str, waited_sec: float,
                      contended: bool) -> None:
        tid = threading.get_ident()
        with self._mutex:
            self._held.setdefault(tid, []).append(name)
            self._hist(self._wait_hist, name).observe(waited_sec)
            if contended:
                self._contended += 1
                self._contention_by_lock[name] = \
                    self._contention_by_lock.get(name, 0) + 1

    def note_released(self, name: str, held_sec: float) -> None:
        tid = threading.get_ident()
        with self._mutex:
            stack = self._held.get(tid, [])
            if name in stack:
                stack.reverse()
                stack.remove(name)  # innermost occurrence
                stack.reverse()
            if not stack:
                self._held.pop(tid, None)
            self._hist(self._hold_hist, name).observe(held_sec)

    def held_by_current_thread(self) -> List[str]:
        with self._mutex:
            return list(self._held.get(threading.get_ident(), ()))

    def note_reentry(self, name: str, site: str) -> None:
        with self._mutex:
            entry = {"lock": name, "site": site,
                     "thread": threading.current_thread().name}
            self._reentries.append(entry)

    def note_watchdog_dump(self) -> None:
        with self._mutex:
            self._watchdog_dumps += 1

    # -- reporting -----------------------------------------------------------
    @property
    def inversions(self) -> List[dict]:
        with self._mutex:
            return list(self._inversions)

    @property
    def reentries(self) -> List[dict]:
        with self._mutex:
            return list(self._reentries)

    def report(self) -> dict:
        with self._mutex:
            return {
                "acquisitions": self._acquisitions,
                "contended": self._contended,
                "watchdogDumps": self._watchdog_dumps,
                "inversions": list(self._inversions),
                "reentries": list(self._reentries),
                "edges": {k: sorted(v)
                          for k, v in sorted(self._edges.items())},
                "contentionByLock": dict(self._contention_by_lock),
            }

    def reset(self) -> None:
        """Drop all recorded state (tests)."""
        with self._mutex:
            self._edges.clear()
            self._edge_sites.clear()
            self._inversions.clear()
            self._reported_pairs.clear()
            self._reentries.clear()
            self._acquisitions = 0
            self._contended = 0
            self._watchdog_dumps = 0
            self._wait_hist.clear()
            self._hold_hist.clear()
            self._contention_by_lock.clear()
            self._held.clear()

    def _histogram_children(self) -> List[Tuple[str, str, Any]]:
        with self._mutex:
            out = [("pio_lock_wait_seconds", n, h)
                   for n, h in sorted(self._wait_hist.items())]
            out += [("pio_lock_hold_seconds", n, h)
                    for n, h in sorted(self._hold_hist.items())]
            return out


_registry: Optional[LockRegistry] = None
_registry_mutex = threading.Lock()


def lock_registry() -> LockRegistry:
    global _registry
    with _registry_mutex:
        if _registry is None:
            _registry = LockRegistry()
        return _registry


# ---------------------------------------------------------------------------
# the instrumented lock
# ---------------------------------------------------------------------------

def _caller_site(depth: int = 2) -> str:
    """``path:line`` of the frame acquiring the lock (skipping this
    module's own frames)."""
    for frame, lineno in traceback.walk_stack(None):
        fn = frame.f_code.co_filename
        if not fn.endswith(("locks.py",)):
            return f"{fn}:{lineno}"
    return "?"


class DebugLock:
    """A named lock that reports ordering, contention, and hold time
    to the process :class:`LockRegistry`, and dumps all thread stacks
    when a wait exceeds the watchdog threshold.

    ``reentrant=False`` wraps ``threading.Lock`` and RAISES on
    same-thread re-acquisition (the plain lock would hang forever);
    ``reentrant=True`` wraps ``threading.RLock`` and permits it.
    """

    def __init__(self, name: str, reentrant: bool = False,
                 registry: Optional[LockRegistry] = None,
                 watchdog_sec: Optional[float] = None) -> None:
        self.name = name
        self.reentrant = reentrant
        self._inner = (threading.RLock() if reentrant
                       else threading.Lock())
        self._registry = registry if registry is not None \
            else lock_registry()
        self._watchdog = (watchdog_sec if watchdog_sec is not None
                          else watchdog_threshold_sec())
        self._local = threading.local()

    def _depth(self) -> int:
        return getattr(self._local, "depth", 0)

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        reg = self._registry
        site = _caller_site()
        depth = self._depth()
        if depth:
            if not self.reentrant:
                reg.note_reentry(self.name, site)
                raise RuntimeError(
                    f"same-thread re-entry on non-reentrant lock "
                    f"{self.name!r} at {site} — the uninstrumented "
                    f"process would deadlock here")
        else:
            reg.note_acquire_attempt(
                self.name, reg.held_by_current_thread(), site)
        t0 = time.monotonic()
        contended = not self._inner.acquire(blocking=False)
        if contended:
            if not blocking:
                return False
            acquired = False
            deadline = (t0 + timeout) if timeout and timeout > 0 \
                else None
            while not acquired:
                step = self._watchdog
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    step = min(step, remaining)
                acquired = self._inner.acquire(timeout=step)
                if not acquired and time.monotonic() - t0 \
                        >= self._watchdog:
                    self._dump_stacks(site, time.monotonic() - t0)
        waited = time.monotonic() - t0
        if depth:  # re-entrant inner acquire: no new edge, no new hold
            self._local.depth = depth + 1
            return True
        self._local.depth = 1
        self._local.acquired_at = time.monotonic()
        reg.note_acquired(self.name, waited, contended)
        return True

    def release(self) -> None:
        depth = self._depth()
        if depth > 1:
            self._local.depth = depth - 1
            self._inner.release()
            return
        held_sec = time.monotonic() - getattr(
            self._local, "acquired_at", time.monotonic())
        self._local.depth = 0
        self._inner.release()
        self._registry.note_released(self.name, held_sec)

    def locked(self) -> bool:
        inner = self._inner
        locked = getattr(inner, "locked", None)
        if locked is not None:
            return locked()
        return False  # RLock has no locked(); best effort

    def __enter__(self) -> "DebugLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __repr__(self) -> str:
        kind = "rlock" if self.reentrant else "lock"
        return f"<DebugLock {self.name!r} ({kind})>"

    def _dump_stacks(self, site: str, waited: float) -> None:
        """The deadlock watchdog: a wait this long is either a deadlock
        or a pathological hold — either way the operator wants every
        thread's stack NOW, in the access log where the serving
        timeline already lives."""
        from .watchdog import dump_all_stacks

        self._registry.note_watchdog_dump()
        dump_all_stacks(
            reason=(f"lock {self.name!r} wait exceeded "
                    f"{self._watchdog:.1f}s (waited {waited:.1f}s so "
                    f"far) at {site}; thread "
                    f"{threading.current_thread().name!r} holds "
                    f"{self._registry.held_by_current_thread()}"))


# ---------------------------------------------------------------------------
# factories — the only lock constructors the serving stack uses
# ---------------------------------------------------------------------------

def new_lock(name: str):
    """A mutex for the serving stack: plain ``threading.Lock`` when
    instrumentation is off (zero overhead), :class:`DebugLock` when
    on. ``name`` keys the order graph and the ``pio_lock_*`` series —
    use ``Class.attr`` so static findings and runtime reports line
    up."""
    if _enabled:
        return DebugLock(name, reentrant=False)
    return threading.Lock()


def new_rlock(name: str):
    """Re-entrant variant of :func:`new_lock`."""
    if _enabled:
        return DebugLock(name, reentrant=True)
    return threading.RLock()


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def register_lock_metrics(registry) -> None:
    """Mount the ``pio_lock_*`` series on a server's
    :class:`~predictionio_tpu_torch.obs.MetricsRegistry`: wait/hold
    histograms per lock plus contention/inversion/re-entry/watchdog
    counters. Safe to call when instrumentation is off — the series
    just stay at zero."""
    reg = lock_registry()
    registry.gauge(
        "pio_lock_instrumented",
        "1 when DebugLock instrumentation is live "
        "(ServerConfig.debug_locks or PTPU_DEBUG_LOCKS=1)",
        fn=lambda: 1.0 if _enabled else 0.0)
    registry.gauge(
        "pio_lock_acquisitions",
        "Lock acquisitions observed by the debug-lock registry "
        "(monotonic)",
        fn=lambda: reg.report()["acquisitions"])
    registry.gauge(
        "pio_lock_contention_total",
        "Acquisitions that had to wait for another holder (monotonic)",
        fn=lambda: reg.report()["contended"])
    registry.gauge(
        "pio_lock_inversions_total",
        "Lock-order inversions detected live — any nonzero value is a "
        "latent deadlock",
        fn=lambda: len(reg.inversions))
    registry.gauge(
        "pio_lock_reentries_total",
        "Same-thread re-entries on non-reentrant locks detected "
        "(each raised instead of deadlocking)",
        fn=lambda: len(reg.reentries))
    registry.gauge(
        "pio_lock_watchdog_dumps_total",
        "Times the deadlock watchdog dumped all thread stacks "
        "(lock wait exceeded PTPU_LOCK_WATCHDOG_SEC)",
        fn=lambda: reg.report()["watchdogDumps"])

    def collect():
        from ..obs.registry import render_histogram_lines

        children = reg._histogram_children()
        if not children:
            return []
        lines: List[str] = []
        last_fam = None
        for fam, lock_name, hist in children:
            if fam != last_fam:
                help_txt = ("Seconds spent waiting to acquire each "
                            "instrumented lock"
                            if fam.endswith("wait_seconds") else
                            "Seconds each instrumented lock was held")
                lines.append(f"# HELP {fam} {help_txt}")
                lines.append(f"# TYPE {fam} histogram")
                last_fam = fam
            lines.extend(render_histogram_lines(
                fam, (("lock", lock_name),), hist))
        return lines

    registry.register_collector(collect)
