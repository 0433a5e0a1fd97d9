"""Replica lifecycle manager: spawn, warm, ready, drain, terminate, as an
explicit state machine (the port's own copy of
``predictionio_tpu/router/lifecycle.py``).

The autoscaler decides *how many* replicas; this module owns *how one
replica joins or leaves* without dropping a query:

- **spawn and warm gating**: a freshly spawned replica serves nothing
  until its own ``/status.json`` reports ``servingWarm`` (the
  ``pio_serving_warm`` gauge): its kernel libraries are loaded and its
  serving ladder has run (``fused_topk`` launched at every batch size)
  before the ring sends it traffic, so its first queries wait on no
  build. Only on READY does the replica enter the router's ring and the
  aggregator's scrape set.
- **drain**: leaving is the mirror image: the replica first drops out
  of the ring (no NEW assignments), is told to advertise ``lifecycle:
  draining`` on its ``/status.json`` (so the fleet aggregator leaves it
  out of rollups and the headroom denominator without an availability
  flap), and only once the router counts zero in-flight requests on it,
  or the drain deadline expires, is it stopped and removed.
- **dead**: the chaos path: a replica that failed its health signal is
  removed at once (best-effort stop), and the autoscaler's next
  evaluation replaces it.

Spawning and probing are injectable callables, so unit tests drive the
state machine with fakes while ``deploy --fleet-of`` plugs in real
engine servers. :meth:`ReplicaLifecycle.close` joins every worker
thread.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..concurrency import new_lock

__all__ = ["ReplicaLifecycle", "STATES"]

#: the full state vocabulary, in lifecycle order
STATES = ("spawning", "warming", "ready", "draining", "terminated",
          "dead")

#: numbers the placeholders of spawns in flight
_SPAWN_SEQ = itertools.count()


def _default_probe(base: str, timeout: float) -> Dict[str, Any]:
    import urllib.request

    with urllib.request.urlopen(base + "/status.json",
                                timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def _default_notify_drain(base: str, timeout: float,
                          accesskey: Optional[str] = None) -> None:
    import urllib.parse
    import urllib.request

    url = base + "/drain"
    if accesskey:
        url += "?accessKey=" + urllib.parse.quote(accesskey)
    req = urllib.request.Request(url, data=b"")
    with urllib.request.urlopen(req, timeout=timeout):
        pass


class _Managed:
    __slots__ = ("name", "base", "stop_fn", "state", "since",
                 "reason")

    def __init__(self, name: str, base: str,
                 stop_fn: Optional[Callable[[], None]],
                 state: str, now: float) -> None:
        self.name = name
        self.base = base
        self.stop_fn = stop_fn
        self.state = state
        self.since = now
        self.reason = ""


class ReplicaLifecycle:
    """Owns the managed-replica table and the per-replica worker
    threads that walk the state machine.

    ``spawn() -> (replica_spec, stop_fn)`` boots one replica and
    returns its address (``host:port`` or URL) plus the callable that
    stops it. ``probe(base, timeout) -> status-dict`` and
    ``notify_drain(base, timeout)`` default to real HTTP.
    """

    def __init__(self, spawn: Callable[[], Tuple[str, Callable[[], None]]],
                 router=None, aggregator=None, registry=None,
                 probe: Callable[[str, float], Dict[str, Any]] = None,
                 notify_drain: Callable[[str, float], None] = None,
                 warm_timeout_sec: float = 300.0,
                 drain_deadline_sec: float = 30.0,
                 poll_interval_sec: float = 0.25,
                 probe_timeout_sec: float = 10.0,
                 on_transition: Optional[Callable[..., None]] = None,
                 accesskey: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._spawn = spawn
        self.router = router
        self.aggregator = aggregator
        self._probe = probe or _default_probe
        self._notify_drain = notify_drain or (
            lambda base, timeout: _default_notify_drain(
                base, timeout, accesskey))
        self.warm_timeout_sec = warm_timeout_sec
        self.drain_deadline_sec = drain_deadline_sec
        self.poll_interval_sec = poll_interval_sec
        self.probe_timeout_sec = probe_timeout_sec
        self.on_transition = on_transition
        self._clock = clock
        self._lock = new_lock("ReplicaLifecycle._lock")
        self._replicas: Dict[str, _Managed] = {}
        self._threads: List[threading.Thread] = []
        self._closed = threading.Event()
        self._transitions = None
        if registry is not None:
            self._transitions = registry.counter(
                "pio_autoscale_transitions_total",
                "Replica lifecycle transitions by destination state")
            fam = registry.gauge(
                "pio_autoscale_replicas",
                "Managed replicas by lifecycle state "
                "(spawning|warming|ready|draining)")
            for state in ("spawning", "warming", "ready", "draining"):
                fam.labels(state=state).set_fn(
                    (lambda s: lambda: float(self.count(s)))(state))

    # -- bookkeeping --------------------------------------------------------
    def _set_state(self, m: _Managed, state: str,
                   reason: str = "") -> None:
        with self._lock:
            m.state = state
            m.since = self._clock()
            m.reason = reason
        if self._transitions is not None:
            self._transitions.labels(to=state).inc()
        if self.on_transition is not None:
            try:
                self.on_transition(m.name, state, reason)
            except Exception:  # noqa: BLE001 — observer must not
                pass           # break the state machine

    def count(self, state: str) -> int:
        with self._lock:
            return sum(1 for m in self._replicas.values()
                       if m.state == state)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out = {s: 0 for s in STATES}
            for m in self._replicas.values():
                out[m.state] += 1
            return out

    def live_count(self) -> int:
        """Replicas that are capacity now or imminently (spawning +
        warming + ready) — what the autoscaler compares to its
        target, so an in-flight spawn is never double-ordered."""
        with self._lock:
            return sum(1 for m in self._replicas.values()
                       if m.state in ("spawning", "warming", "ready"))

    def names(self, *states: str) -> List[str]:
        with self._lock:
            return [m.name for m in self._replicas.values()
                    if not states or m.state in states]

    def replicas(self) -> List[Dict[str, Any]]:
        now = self._clock()
        with self._lock:
            return [{"replica": m.name, "base": m.base,
                     "state": m.state,
                     "inStateSec": round(now - m.since, 3),
                     "reason": m.reason}
                    for m in self._replicas.values()]

    # -- adopt (pre-existing replicas) --------------------------------------
    def adopt(self, replica: str,
              stop_fn: Optional[Callable[[], None]] = None,
              warm: bool = True) -> str:
        """Register an already-running replica (the initial
        ``--fleet-of`` members). ``warm=False`` walks it through the
        warm gate like a fresh spawn."""
        name, base = _normalize(replica)
        m = _Managed(name, base, stop_fn,
                     "ready" if warm else "warming", self._clock())
        with self._lock:
            self._replicas[name] = m
        if warm:
            if self.router is not None:
                self.router.add(base)
            if self.aggregator is not None:
                self.aggregator.add_replica(base)
            self._set_state(m, "ready", "adopted")
        else:
            self._start_thread(self._warm_then_join, m)
        return name

    # -- scale out ----------------------------------------------------------
    def scale_out(self, reason: str = "") -> None:
        """Order one new replica; returns immediately (spawn + warm
        run on a worker thread — warm-up is seconds-to-minutes)."""
        self._start_thread(self._spawn_one, reason)

    def _spawn_one(self, reason: str) -> None:
        # a name of its own: two spawns in flight must not share one
        # entry (the id of a freed temporary repeats)
        placeholder = _Managed(f"(spawning-{next(_SPAWN_SEQ):x})", "",
                               None, "spawning", self._clock())
        with self._lock:
            self._replicas[placeholder.name] = placeholder
        try:
            spec, stop_fn = self._spawn()
        except Exception as e:  # noqa: BLE001 — a failed spawn is a
            # data point for the next evaluation, not a crash
            self._set_state(placeholder, "dead",
                            f"spawn failed: {e}")
            return
        name, base = _normalize(spec)
        with self._lock:
            del self._replicas[placeholder.name]
            m = _Managed(name, base, stop_fn, "warming",
                         self._clock())
            m.reason = reason
            self._replicas[name] = m
        self._set_state(m, "warming", reason)
        self._warm_then_join(m)

    def _warm_then_join(self, m: _Managed) -> None:
        deadline = self._clock() + self.warm_timeout_sec
        artifact_warm = False
        while not self._closed.is_set():
            try:
                status = self._probe(m.base, self.probe_timeout_sec)
                if status.get("servingWarm"):
                    # how the replica warmed: libraries a `build` left
                    # in the kernel root, or compiled at this bind
                    artifact_warm = bool(status.get("artifactWarm"))
                    break
            except Exception:  # noqa: BLE001 — not up yet
                pass
            if self._clock() >= deadline:
                self._terminate(m, "warm timeout", state="dead")
                return
            self._closed.wait(self.poll_interval_sec)
        if self._closed.is_set():
            return
        # warm: NOW it may take traffic and be scraped
        if self.router is not None:
            self.router.add(m.base)
        if self.aggregator is not None:
            self.aggregator.add_replica(m.base)
        self._set_state(m, "ready", m.reason or (
            "warmed from artifact" if artifact_warm else "warmed (compile)"))

    # -- scale in -----------------------------------------------------------
    def pick_drain_victim(self) -> Optional[str]:
        """Least-loaded ready replica (fewest in-flight through the
        router), newest first on ties — the cheapest member to lose."""
        with self._lock:
            ready = [m for m in self._replicas.values()
                     if m.state == "ready"]
        if not ready:
            return None
        if self.router is not None:
            ready.sort(key=lambda m: (self.router.inflight(m.name),
                                      -m.since))
        else:
            ready.sort(key=lambda m: -m.since)
        return ready[0].name

    def scale_in(self, name: Optional[str] = None,
                 reason: str = "") -> Optional[str]:
        """Begin draining ``name`` (default: the drain victim);
        returns the name or None when nothing is drainable."""
        victim = name or self.pick_drain_victim()
        if victim is None:
            return None
        with self._lock:
            m = self._replicas.get(victim)
            if m is None or m.state != "ready":
                return None
        self._set_state(m, "draining", reason)
        if self.router is not None:
            self.router.drain(m.name)
        self._start_thread(self._drain_then_stop, m)
        return victim

    def _drain_then_stop(self, m: _Managed) -> None:
        # tell the replica itself: its /status.json flips to
        # lifecycle=draining so the aggregator reclassifies it before
        # its scrapes stop (no pio_fleet_replica_up flap)
        try:
            self._notify_drain(m.base, self.probe_timeout_sec)
        except Exception:  # noqa: BLE001 — an unreachable replica
            pass           # drains by deadline instead
        deadline = self._clock() + self.drain_deadline_sec
        while not self._closed.is_set() and self._clock() < deadline:
            inflight = (self.router.inflight(m.name)
                        if self.router is not None else 0)
            if inflight <= 0:
                break
            self._closed.wait(self.poll_interval_sec)
        self._terminate(m, m.reason or "scale-in", state="terminated")

    # -- hard removal -------------------------------------------------------
    def mark_dead(self, name: str, reason: str = "") -> bool:
        """Chaos path: the replica failed its health signal — remove
        it NOW (best-effort stop, no drain); the autoscaler's next
        evaluation sees the missing capacity and replaces it."""
        with self._lock:
            m = self._replicas.get(name)
            if m is None or m.state in ("terminated", "dead"):
                return False
        self._terminate(m, reason or "died", state="dead")
        return True

    def _terminate(self, m: _Managed, reason: str,
                   state: str) -> None:
        if self.router is not None:
            self.router.remove(m.name)
        if self.aggregator is not None:
            self.aggregator.remove_replica(m.name)
        if m.stop_fn is not None:
            try:
                m.stop_fn()
            except Exception:  # noqa: BLE001 — already dead is fine
                pass
        self._set_state(m, state, reason)
        with self._lock:
            self._replicas.pop(m.name, None)

    # -- plumbing -----------------------------------------------------------
    def _start_thread(self, fn: Callable, *args: Any) -> None:
        t = threading.Thread(target=fn, args=args, daemon=True,
                             name="replica-lifecycle")
        with self._lock:
            self._threads = [th for th in self._threads
                             if th.is_alive()]
            self._threads.append(t)
        t.start()

    def await_ready(self, n: int, timeout_sec: float = 300.0) -> bool:
        """Block until ``n`` replicas are READY (smokes/tests)."""
        deadline = self._clock() + timeout_sec
        while self._clock() < deadline:
            if self.count("ready") >= n:
                return True
            if self._closed.wait(self.poll_interval_sec):
                return False
        return self.count("ready") >= n

    def close(self, stop_replicas: bool = False) -> None:
        """Stop the worker threads (and optionally every managed
        replica — the smoke's teardown)."""
        self._closed.set()
        with self._lock:
            threads = list(self._threads)
            managed = list(self._replicas.values())
        for t in threads:
            t.join(timeout=10)
        if stop_replicas:
            for m in managed:
                if m.stop_fn is not None:
                    try:
                        m.stop_fn()
                    except Exception:  # noqa: BLE001
                        pass


def _normalize(replica: str) -> Tuple[str, str]:
    r = replica.strip().rstrip("/")
    if "://" in r:
        return r.split("://", 1)[1], r
    return r, "http://" + r
