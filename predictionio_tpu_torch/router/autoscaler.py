"""SLO-driven autoscaler (the port's own copy of
``predictionio_tpu/router/autoscaler.py``).

One control loop acts on the fleet aggregator's merged signals
(``pio_fleet_capacity_headroom``, the fleet-scoped SLOs).

**Scale out** when either leading indicator fires:

- the fleet SLO's *fast-window* burn is lit
  (:meth:`~predictionio_tpu_torch.slo.SLOEngine.fast_burning`): the
  minutes-scale early warning, deliberately not the confirmed breach,
  because capacity added after the slow window confirms is capacity
  added too late;
- capacity headroom (``1 - qps/(knee x replicas)``) drops under
  ``headroom_floor``: the model-predicted approach to the knee, which
  fires even while latency still looks fine. Without a capacity model
  (no ``CAPACITY.json``) there is no headroom and this branch never
  fires.

**Scale in** only against the knee model, with hysteresis: headroom
must exceed ``headroom_ceiling`` (strictly above the floor)
*continuously* for ``scale_in_sustain_sec``, nothing may be burning,
and the cooldown since the last action must have elapsed. The band,
the sustain window and the cooldown make the loop flap-free: removing
one replica raises utilization by ``n/(n-1)``, and the ceiling is
chosen so the post-removal headroom still clears the floor.

**Heal** is separate from policy: a replica that died (health signal
down) is replaced at once, cooldown or not.

The order of one evaluation is heal, then the manual target, then the
fast burn, then the headroom floor, then scale-in. Every decision is
traced (force-retained under reason ``autoscale``), appended to a
bounded decision log on the fleet's ``/fleet.json`` and counted in the
``pio_autoscale_*`` families.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import asdict, dataclass
from typing import Any, Callable, Dict, List, Optional

from ..concurrency import new_lock

__all__ = ["AutoscalePolicy", "Autoscaler"]


@dataclass
class AutoscalePolicy:
    """The scaling contract (CLI: ``--autoscale --min-replicas
    --max-replicas``)."""

    min_replicas: int = 1
    max_replicas: int = 8
    #: scale out when fleet headroom drops below this
    headroom_floor: float = 0.15
    #: scale in only while headroom exceeds this (it must clear the
    #: floor even after losing one replica)
    headroom_ceiling: float = 0.60
    #: the ceiling must hold continuously this long before a scale-in
    scale_in_sustain_sec: float = 30.0
    #: no policy action within this window of the previous one
    cooldown_sec: float = 30.0
    #: evaluation cadence of the control loop
    interval_sec: float = 1.0

    def __post_init__(self) -> None:
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas < min_replicas")
        if self.headroom_ceiling <= self.headroom_floor:
            raise ValueError(
                "headroom_ceiling must exceed headroom_floor "
                "(the hysteresis band)")


class Autoscaler:
    """Evaluates policy against the aggregator's merged signals and
    orders the lifecycle manager around. ``evaluate()`` is one pure
    tick (tests drive it with a fake clock); ``start()`` runs it on a
    timer thread."""

    LOG_LIMIT = 256

    def __init__(self, aggregator, lifecycle,
                 policy: Optional[AutoscalePolicy] = None,
                 registry=None, tracer=None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.agg = aggregator
        self.lifecycle = lifecycle
        self.policy = policy or AutoscalePolicy()
        self.tracer = tracer
        self._clock = clock
        self._lock = new_lock("Autoscaler._lock")
        self._log: deque = deque(maxlen=self.LOG_LIMIT)
        self._removed: List[str] = []   # intentional scale-in exits
        self._seq = 0
        self._target: Optional[int] = None
        self._manual: Optional[int] = None
        self._manual_reason = ""
        self._last_action = -1e18
        self._ceiling_since: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

        self._decisions_total = None
        if registry is not None:
            self._decisions_total = registry.counter(
                "pio_autoscale_decisions_total",
                "Control-loop decisions by action (hold|scale_out|"
                "scale_in|replace|manual)")
            registry.gauge(
                "pio_autoscale_target_replicas",
                "The replica count the autoscaler is currently "
                "holding the fleet to"
            ).set_fn(lambda: float(self._target or 0))
        # intentional-exit bookkeeping rides the lifecycle's
        # transition stream (chained — deploy may have its own hook)
        prev = lifecycle.on_transition
        def _on_transition(name: str, state: str,
                           reason: str) -> None:
            if state == "terminated":
                with self._lock:
                    self._removed.append(name)
                    del self._removed[:-self.LOG_LIMIT]
            if prev is not None:
                prev(name, state, reason)
        lifecycle.on_transition = _on_transition

    # -- control ------------------------------------------------------------
    def request_target(self, n: int, reason: str = "") -> int:
        """Manual override (``fleet scale``): clamp to policy
        bounds and converge on the next evaluation."""
        n = max(self.policy.min_replicas,
                min(self.policy.max_replicas, int(n)))
        with self._lock:
            self._manual = n
            self._manual_reason = reason or "manual scale request"
        return n

    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(target=self._loop,
                                        name="autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.evaluate()
            except Exception:  # noqa: BLE001 — the loop must outlive
                pass           # any single bad tick
            self._stop.wait(self.policy.interval_sec)

    # -- one tick -----------------------------------------------------------
    def evaluate(self) -> Dict[str, Any]:
        now = self._clock()
        pol = self.policy
        signals = self.agg.capacity_signals()
        headroom = signals.get("headroom")
        burning_fast = (self.agg.slo.fast_burning()
                        if self.agg.slo is not None else [])
        live = self.lifecycle.live_count()
        ready = self.lifecycle.count("ready")

        # heal pass: replicas the aggregator has marked DOWN are
        # corpses — remove + replace outside the cooldown
        dead = [name for name in self.lifecycle.names("ready")
                if self.agg.replica_health(name) == "down"]
        for name in dead:
            self.lifecycle.mark_dead(name, "fleet health: down")
        with self._lock:
            if self._target is None:
                self._target = max(pol.min_replicas, live)
            target = self._target
            manual = self._manual
            manual_reason = self._manual_reason
            cooling = now - self._last_action < pol.cooldown_sec
            # hysteresis sustain tracking
            if headroom is not None \
                    and headroom > pol.headroom_ceiling:
                if self._ceiling_since is None:
                    self._ceiling_since = now
                sustained = (now - self._ceiling_since
                             >= pol.scale_in_sustain_sec)
            else:
                self._ceiling_since = None
                sustained = False

        action, reason = "hold", ""
        if dead:
            action = "replace"
            reason = (f"replaced {len(dead)} dead replica(s): "
                      f"{', '.join(dead)}")
            live = self.lifecycle.live_count()
        elif manual is not None and manual != live:
            action, target = "manual", manual
            reason = manual_reason
        elif manual is not None:
            with self._lock:
                self._manual = None  # converged
            target = manual
        elif burning_fast and live < pol.max_replicas \
                and not cooling:
            action = "scale_out"
            target = min(pol.max_replicas, live + 1)
            reason = ("fleet SLO fast burn lit: "
                      + ", ".join(burning_fast))
        elif headroom is not None and headroom < pol.headroom_floor \
                and live < pol.max_replicas and not cooling:
            action = "scale_out"
            target = min(pol.max_replicas, live + 1)
            reason = (f"headroom {headroom:.3f} under floor "
                      f"{pol.headroom_floor}")
        elif sustained and not burning_fast and not cooling \
                and ready > pol.min_replicas and live > pol.min_replicas:
            action = "scale_in"
            target = max(pol.min_replicas, live - 1)
            reason = (f"headroom {headroom:.3f} over ceiling "
                      f"{pol.headroom_ceiling} for "
                      f"{pol.scale_in_sustain_sec}s")

        # converge toward the target OUTSIDE the lock (lifecycle has
        # its own locks and spawns threads)
        acted = False
        if action == "replace" or live < target:
            missing = max(target - live, 0)
            for _ in range(missing):
                self.lifecycle.scale_out(reason or "below target")
                acted = True
        elif action in ("scale_in", "manual") and live > target:
            for _ in range(live - target):
                if self.lifecycle.scale_in(reason=reason) is None:
                    break
                acted = True
        elif action == "scale_out":
            # target rose but live already matches (a spawn from the
            # previous tick is in flight): no duplicate order
            acted = live < target

        decision = {
            "action": action,
            "reason": reason,
            "headroom": (round(headroom, 4)
                         if headroom is not None else None),
            "qps": round(signals.get("qps") or 0.0, 2),
            "kneeQps": signals.get("kneeQps"),
            "burningFast": burning_fast,
            "live": live,
            "ready": ready,
            "target": target,
            "wallTime": time.time(),
        }
        with self._lock:
            self._target = target
            if action != "hold":
                self._last_action = now
                self._ceiling_since = None
            self._seq += 1
            decision["seq"] = self._seq
        if self._decisions_total is not None:
            self._decisions_total.labels(action=action).inc()
        if action != "hold":
            decision["traceId"] = self._trace(decision)
            with self._lock:
                self._log.append(decision)
        return decision

    def _trace(self, decision: Dict[str, Any]) -> Optional[str]:
        """One span per non-hold decision, force-retained under the
        ``autoscale`` reason so the flight recorder keeps the why of
        every scaling event."""
        if self.tracer is None:
            return None
        trace = self.tracer.begin(
            f"autoscale.{decision['action']}", server="autoscaler")
        for k in ("reason", "headroom", "qps", "live", "target"):
            trace.set_attr(k, decision[k])
        self.tracer.finish(trace, status=200,
                           force_reason="autoscale")
        return trace.trace_id

    # -- read side ----------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        """The ``autoscale`` block of ``/fleet.json``: policy, live
        target, lifecycle counts, the decision log, and the
        intentional-exit list ``fleet status`` consults to tell
        scale-in from death."""
        with self._lock:
            log = list(self._log)
            removed = list(self._removed)
            target = self._target
        return {
            "enabled": True,
            "running": (self._thread is not None
                        and self._thread.is_alive()),
            "policy": asdict(self.policy),
            "target": target,
            "lifecycle": self.lifecycle.counts(),
            "replicas": self.lifecycle.replicas(),
            "removed": removed,
            "decisions": log,
        }
