"""The SLO engine: multi-window error-budget accounting over live metrics
(the port's own copy of ``predictionio_tpu/slo/engine.py``).

The engine ticks on a clock (a background thread in a deployed server, a
synthetic clock in tests) and on every tick takes one *cumulative*
sample per spec from the
:class:`~predictionio_tpu_torch.obs.MetricsRegistry`: total events, bad
events and, for histogram-backed objectives, the cumulative bucket
vector. Windows are then pure snapshot arithmetic: the delta between the
newest sample and the newest sample at least ``window`` old IS the
window's own histogram (the cumulative-bucket-delta read of
:func:`~predictionio_tpu_torch.obs.histogram.window_quantile`), so burn
rates never store per-event data.

States per spec:

- ``insufficient_data``: a window reaches back past the first sample
  (the engine just started) or a sample regressed (a histogram reset).
  NOT a breach: a cold window says nothing about the service, never
  "quantile 0 ms, all good" nor "breach".
- ``idle``: windows covered but no traffic in the slow window.
- ``ok`` / ``breach``: the multi-window verdict: breach while the fast
  window burns at least ``burn_fast`` x budget AND the slow window at
  least ``burn_slow`` x. ``pio_slo_violations_total`` counts ok->breach
  transitions; the transition hook lets the server force-retain
  flight-recorder traces for the duration of the burn.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..concurrency import new_lock
from ..obs.histogram import window_quantile
from .spec import SLOSpec

log = logging.getLogger(__name__)

Buckets = List[Tuple[float, int]]

#: hard cap on samples retained per spec: at the default 1 s tick this
#: covers a >2 h budget window at full resolution; a longer budget
#: window coarsens to the oldest retained sample instead of growing
#: memory forever
RING_CAP = 8192


class _Sample:
    """One cumulative observation: monotonic time, total events, bad
    events, and the summed cumulative buckets (histogram specs)."""

    __slots__ = ("t", "total", "bad", "buckets")

    def __init__(self, t: float, total: float, bad: float,
                 buckets: Optional[Buckets]):
        self.t = t
        self.total = total
        self.bad = bad
        self.buckets = buckets


def _bad_above(buckets: Buckets, threshold_s: float) -> float:
    """Events strictly above ``threshold_s`` in a cumulative bucket
    vector, interpolating inside the bucket the threshold lands in
    (the same estimator the quantile read uses, run in reverse)."""
    total = buckets[-1][1]
    prev_le, prev_cum = 0.0, 0
    for le, cum in buckets:
        if threshold_s <= le:
            if math.isinf(le):
                return float(total - cum)  # threshold past the last
                # finite bound: only overflow-bucket events are bad,
                # and they are all in cum already → none measurable
            n = cum - prev_cum
            lo = prev_le
            frac = (threshold_s - lo) / (le - lo) if le > lo else 1.0
            good = prev_cum + n * min(max(frac, 0.0), 1.0)
            return float(total - good)
        prev_le, prev_cum = le, cum
    return 0.0


class _SpecState:
    """One spec's ring of samples plus its live verdict."""

    __slots__ = ("spec", "ring", "state", "burn_fast", "burn_slow",
                 "budget_remaining", "current", "violations",
                 "breach_since", "last_t")

    def __init__(self, spec: SLOSpec):
        self.spec = spec
        self.ring: deque = deque(maxlen=RING_CAP)
        self.state = "insufficient_data"
        self.burn_fast: Optional[float] = None
        self.burn_slow: Optional[float] = None
        self.budget_remaining: Optional[float] = None
        self.current: Dict[str, Any] = {}
        self.violations = 0
        self.breach_since: Optional[float] = None
        self.last_t: Optional[float] = None


class SLOEngine:
    """Evaluates :class:`SLOSpec`s against a live metrics registry.

    Thread-safe; drive it with :meth:`observe` (one tick, synthetic
    clocks welcome) or :meth:`start`/:meth:`stop` (a daemon ticker).
    ``on_transition(spec, breached, info)`` fires OUTSIDE the engine
    lock on every ok↔breach edge.
    """

    def __init__(self, registry, specs: List[SLOSpec],
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[
                     Callable[[SLOSpec, bool, Dict[str, Any]],
                              None]] = None):
        if not specs:
            raise ValueError("SLOEngine needs at least one spec")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError("duplicate SLO spec names")
        self.registry = registry
        self.clock = clock
        self.on_transition = on_transition
        self._states = {s.name: _SpecState(s) for s in specs}
        self._lock = new_lock("SLOEngine._lock")
        self._ticks = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._viol_counter = None  # bound by register_metrics

    # -- sampling ----------------------------------------------------------
    def _matches(self, items: Tuple[Tuple[str, str], ...],
                 scope: Dict[str, str]) -> bool:
        d = dict(items)
        return all(d.get(k) == v for k, v in scope.items())

    def _sample(self, spec: SLOSpec) -> Optional[Tuple[float, float,
                                                       Optional[Buckets]]]:
        """One cumulative (total, bad, buckets) read for ``spec``;
        None while the metric family does not exist yet."""
        fam = self.registry.get(spec.resolved_metric())
        if fam is None:
            return None
        if fam.kind == "counter":
            # availability: status label >= 500 is the bad class
            # (includes deadline-shed 503s — an unanswered query is
            # unavailable no matter how gracefully it was shed)
            total = bad = 0.0
            for items, child in fam.children():
                if not self._matches(items, spec.scope):
                    continue
                v = float(child.value)
                total += v
                try:
                    code = int(dict(items).get("status", "0"))
                except ValueError:
                    code = 0
                if code >= 500:
                    bad += v
            return total, bad, None
        if fam.kind == "histogram":
            agg: Optional[Buckets] = None
            for items, child in fam.children():
                if not self._matches(items, spec.scope):
                    continue
                bc = child.bucket_counts()
                if agg is None:
                    agg = bc
                elif len(bc) == len(agg):
                    agg = [(le, c0 + c1) for (le, c0), (_, c1)
                           in zip(agg, bc)]
            if agg is None:
                return None
            total = float(agg[-1][1])
            thr = float(spec.threshold_ms or 0.0) / 1000.0
            return total, _bad_above(agg, thr), agg
        return None  # gauges carry no event counts to budget against

    # -- window arithmetic -------------------------------------------------
    @staticmethod
    def _window(st: _SpecState, now: float, window: float):
        """``(d_total, d_bad, anchor, covered)`` between the newest
        sample and the newest sample at least ``window`` old; None
        while fewer than two samples exist or a sample regressed
        (reset between snapshots — a wrapped window is no window)."""
        ring = st.ring
        if len(ring) < 2:
            return None
        latest = ring[-1]
        cutoff = now - window
        anchor = None
        for s in reversed(ring):
            if s.t <= cutoff:
                anchor = s
                break
        covered = anchor is not None
        if anchor is None:
            anchor = ring[0]
        d_total = latest.total - anchor.total
        d_bad = latest.bad - anchor.bad
        if d_total < 0 or d_bad < 0:
            return None
        return d_total, d_bad, anchor, covered

    # -- evaluation --------------------------------------------------------
    def observe(self, now: Optional[float] = None) -> None:
        """One tick: sample every spec, re-evaluate, fire transitions
        (outside the lock)."""
        t = self.clock() if now is None else float(now)
        transitions: List[Tuple[SLOSpec, bool, Dict[str, Any]]] = []
        with self._lock:
            self._ticks += 1
            for st in self._states.values():
                sampled = self._sample(st.spec)
                if sampled is not None:
                    total, bad, buckets = sampled
                    st.ring.append(_Sample(t, total, bad, buckets))
                    st.last_t = t
                edge = self._evaluate(st, t)
                if edge is not None:
                    transitions.append(edge)
        for spec, breached, info in transitions:
            if breached:
                log.warning(
                    "SLO BREACH %s: fast burn %.1fx over %gs, slow "
                    "burn %.1fx over %gs (budget %.4f)", spec.name,
                    info.get("burnFast") or 0.0, spec.window_fast_sec,
                    info.get("burnSlow") or 0.0, spec.window_slow_sec,
                    spec.budget)
            else:
                log.warning("SLO recovered: %s", spec.name)
            if self.on_transition is not None:
                try:
                    self.on_transition(spec, breached, info)
                except Exception:  # noqa: BLE001 — a broken hook must
                    log.exception(  # never stop the evaluator
                        "SLO transition hook failed for %s", spec.name)

    def _evaluate(self, st: _SpecState, now: float):
        """Re-derive one spec's verdict; returns a transition tuple on
        an ok↔breach edge, else None. Caller holds the lock."""
        spec = st.spec
        was_breaching = st.state == "breach"
        fast = self._window(st, now, spec.window_fast_sec)
        slow = self._window(st, now, spec.window_slow_sec)
        st.burn_fast = st.burn_slow = None
        st.current = {}
        if fast is None or slow is None:
            st.state = "insufficient_data"
            return self._edge(st, was_breaching, False)
        f_total, f_bad, f_anchor, f_cov = fast
        s_total, s_bad, s_anchor, s_cov = slow
        if f_total > 0:
            st.burn_fast = (f_bad / f_total) / spec.budget
        if s_total > 0:
            st.burn_slow = (s_bad / s_total) / spec.budget
        # budget accounting over the compliance window (event-based:
        # consumed = bad / (budget × total)); an uncovered budget
        # window accounts since engine start — the honest best effort
        budget_win = self._window(st, now, spec.budget_window_sec)
        st.budget_remaining = None
        if budget_win is not None and budget_win[0] > 0:
            consumed = (budget_win[1] / budget_win[0]) / spec.budget
            st.budget_remaining = max(0.0, 1.0 - consumed)
        # the human-facing "current" read per objective
        latest = st.ring[-1]
        if spec.objective == "availability":
            if f_total > 0:
                st.current["errorRatio"] = round(f_bad / f_total, 6)
        elif latest.buckets is not None and f_anchor.buckets is not None:
            q = window_quantile(f_anchor.buckets, latest.buckets, 0.99)
            if q is not None:
                st.current["p99Ms"] = round(q * 1000.0, 3)
            st.current["badFraction"] = (round(f_bad / f_total, 6)
                                         if f_total > 0 else None)
        if not (f_cov and s_cov):
            # the lookback predates the first sample: whatever burn we
            # can compute describes a shorter window than promised —
            # report it, but never breach off it
            st.state = "insufficient_data"
            return self._edge(st, was_breaching, False)
        if s_total <= 0:
            st.state = "idle"
            return self._edge(st, was_breaching, False)
        breaching = (st.burn_fast is not None
                     and st.burn_slow is not None
                     and st.burn_fast >= spec.burn_fast
                     and st.burn_slow >= spec.burn_slow)
        st.state = "breach" if breaching else "ok"
        return self._edge(st, was_breaching, breaching, now)

    def _edge(self, st: _SpecState, was: bool, is_now: bool,
              now: Optional[float] = None):
        if is_now and not was:
            st.violations += 1
            st.breach_since = now
            if self._viol_counter is not None:
                self._viol_counter.labels(slo=st.spec.name).inc()
            return st.spec, True, self._info(st)
        if was and not is_now:
            st.breach_since = None
            return st.spec, False, self._info(st)
        return None

    def _info(self, st: _SpecState) -> Dict[str, Any]:
        return {
            "name": st.spec.name,
            "objective": st.spec.objective,
            "state": st.state,
            "burnFast": st.burn_fast,
            "burnSlow": st.burn_slow,
            "budgetRemaining": st.budget_remaining,
            "violations": st.violations,
            "windows": {"fastSec": st.spec.window_fast_sec,
                        "slowSec": st.spec.window_slow_sec,
                        "budgetSec": st.spec.budget_window_sec},
            "target": st.spec.target,
            "thresholdMs": st.spec.threshold_ms,
            "scope": dict(st.spec.scope),
            "metric": st.spec.resolved_metric(),
            "current": dict(st.current),
        }

    # -- read side ---------------------------------------------------------
    def burning(self) -> List[str]:
        with self._lock:
            return [n for n, st in self._states.items()
                    if st.state == "breach"]

    def fast_burning(self) -> List[str]:
        """Specs whose FAST window alone is burning ≥ its threshold —
        the minutes-scale early warning the autoscaler keys scale-out
        on. Deliberately looser than :meth:`burning` (which also
        requires the slow window): capacity added only after the slow
        window confirms the breach is capacity added too late."""
        with self._lock:
            return [n for n, st in self._states.items()
                    if st.burn_fast is not None
                    and st.burn_fast >= st.spec.burn_fast]

    def status(self) -> Dict[str, Any]:
        """The ``/slo.json`` payload (and the ``slo`` block of
        ``/status.json``)."""
        with self._lock:
            specs = [self._info(st) for st in self._states.values()]
            burning = [s["name"] for s in specs
                       if s["state"] == "breach"]
            ticks = self._ticks
            running = self._thread is not None
        return {
            "enabled": True,
            "running": running,
            "ticks": ticks,
            "burning": burning,
            "specs": specs,
        }

    # -- metrics -----------------------------------------------------------
    def register_metrics(self, registry) -> None:
        """Mount the four ``pio_slo_*`` families on ``registry``."""
        budget_fam = registry.gauge(
            "pio_slo_budget_remaining",
            "Fraction of the error budget left over the spec's "
            "compliance window (1 = untouched, 0 = exhausted; -1 "
            "while there is no data to account against)")
        burn_fam = registry.gauge(
            "pio_slo_burn_rate",
            "Error-budget burn rate (1.0 = burning exactly the "
            "budget) per spec and window (fast | slow); 0 while "
            "unknown")
        breach_fam = registry.gauge(
            "pio_slo_breach",
            "1 while the spec's fast AND slow windows both burn past "
            "their alert thresholds")
        self._viol_counter = registry.counter(
            "pio_slo_violations_total",
            "ok->breach transitions per SLO spec (each one has "
            "force-retained flight-recorder traces riding along)")

        def _bind(name: str) -> None:
            def read(field: str, default: float = 0.0):
                with self._lock:
                    st = self._states.get(name)
                    if st is None:
                        return default
                    v = getattr(st, field)
                    return default if v is None else float(v)

            budget_fam.labels(slo=name).set_fn(
                lambda: read("budget_remaining", -1.0))
            burn_fam.labels(slo=name, window="fast").set_fn(
                lambda: read("burn_fast"))
            burn_fam.labels(slo=name, window="slow").set_fn(
                lambda: read("burn_slow"))
            breach_fam.labels(slo=name).set_fn(
                lambda: 1.0 if self._state_name(name) == "breach"
                else 0.0)
            # a zero sample per spec so the series exists (and the
            # label set is visible) before the first violation
            self._viol_counter.labels(slo=name).inc(0.0)

        for name in self._states:
            _bind(name)

    def _state_name(self, name: str) -> str:
        with self._lock:
            st = self._states.get(name)
            return st.state if st is not None else "unknown"

    # -- ticker ------------------------------------------------------------
    def start(self, interval_sec: float = 1.0) -> None:
        """Start the background evaluator (idempotent)."""
        if interval_sec <= 0:
            raise ValueError("interval_sec must be positive")
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()
            thread = threading.Thread(
                target=self._run, args=(float(interval_sec),),
                daemon=True, name="slo-engine")
            self._thread = thread
        thread.start()

    def _run(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                self.observe()
            except Exception:  # noqa: BLE001 — the evaluator must
                log.exception("SLO tick failed")  # outlive a bad tick

    def stop(self, timeout: float = 5.0) -> None:
        with self._lock:
            thread = self._thread
            self._thread = None
        if thread is None:
            return
        self._stop.set()
        thread.join(timeout=timeout)
