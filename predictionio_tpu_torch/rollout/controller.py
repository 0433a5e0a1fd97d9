"""The rollout controller: the health-gated ramp / rollback loop (the
port's own copy of ``predictionio_tpu/rollout/controller.py``).

One gate thread per live candidate. Each ``policy.window_sec`` it diffs
the engine server's per-arm release series (queries, errors, latency
buckets) against the window-start snapshot, asks the
:class:`~.policy.HealthPolicy` for a verdict, and acts:

- ``advance``: step the splitter up the ramp (1% -> 5% -> 25% -> 100%);
  past the last step the candidate is promoted: the server rebinds it as
  the stable release and the registry pins it.
- ``rollback``: the candidate is unbound (stable never stopped serving)
  and the registry records why.
- ``hold``: the window stays open and the sample keeps accumulating; an
  idle canary neither promotes nor rolls back.

Shadow mode never promotes or rolls back by itself: mirrored answers are
discarded, so candidate errors cost no user traffic; each healthy window
is recorded for the operator to act on.

What the loop decides shows in the ``pio_release_*`` families of the
server's registry, on ``/release.json``, and in the registry's history
with the gate's reason strings. :meth:`RolloutController.stop` joins the
gate thread; ``QueryServer.close()`` calls it.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, Optional

from ..concurrency import new_lock
from .policy import ArmWindow, Decision, HealthPolicy, window_quantile
from .registry import ReleaseRegistry
from .splitter import ARM_CANDIDATE, ARM_STABLE, TrafficSplitter

log = logging.getLogger(__name__)


class RolloutController:
    """Owns one candidate's progressive-delivery lifecycle."""

    def __init__(self, server: Any, registry: ReleaseRegistry,
                 instance_id: str,
                 policy: Optional[HealthPolicy] = None,
                 fraction: Optional[float] = None,
                 shadow: bool = False, actor: str = ""):
        self.server = server
        self.registry = registry
        self.instance_id = instance_id
        self.policy = policy or HealthPolicy()
        self.shadow = shadow
        self.actor = actor or "rollout-controller"
        start_fraction = (fraction if fraction is not None
                          else (1.0 if shadow else self.policy.ramp[0]))
        self.splitter = TrafficSplitter(start_fraction, shadow=shadow)
        self._stop = threading.Event()
        self._lock = new_lock("RolloutController._lock")
        self.active = True
        self.outcome = ""      # "" while live; "promoted" | "rolled_back"
        self.windows = 0
        self.last_decision: Optional[Decision] = None
        self.last_windows: Dict[str, dict] = {}
        self._baseline = {arm: server.release_arm_snapshot(arm)
                          for arm in (ARM_STABLE, ARM_CANDIDATE)}
        self._register_metrics()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="rollout-controller")

    # -- metrics ------------------------------------------------------------
    def _register_metrics(self) -> None:
        reg = self.server.metrics
        # the gauges read plain attributes at scrape time: a sample one
        # scrape interval stale is what a gauge tolerates
        reg.gauge(
            "pio_release_canary_fraction",
            "Traffic fraction routed (canary) or mirrored (shadow) to "
            "the candidate release",
            # ptpu: guarded-by[_lock] — a scrape-time read of a bool
            # flag (written under _lock): atomic in CPython, at most one
            # scrape interval stale
            fn=lambda: self.splitter.fraction if self.active else 0.0)
        reg.gauge(
            "pio_release_rollout_active",
            "1 while a candidate release is bound and health-gated",
            # ptpu: guarded-by[_lock] — the same scrape-time read
            fn=lambda: 1.0 if self.active else 0.0)
        reg.gauge(
            "pio_release_shadow_mode",
            "1 when the live rollout mirrors instead of splitting",
            # ptpu: guarded-by[_lock] — the same scrape-time read
            fn=lambda: 1.0 if (self.active and self.shadow) else 0.0)
        self._promotions = reg.counter(
            "pio_release_promotions_total",
            "Candidates promoted to stable (auto or forced)")
        self._rollbacks = reg.counter(
            "pio_release_rollbacks_total",
            "Candidates rolled back (health gate or operator)")
        self._ramp_steps = reg.counter(
            "pio_release_ramp_steps_total",
            "Healthy windows that stepped the canary fraction up")
        self._windows_total = reg.counter(
            "pio_release_gate_windows_total",
            "Health-gate windows evaluated, by verdict")

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "RolloutController":
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the loop without touching bindings (server shutdown) and
        join the gate thread (not from the gate thread itself: a
        verdict's promote or rollback ends the loop there)."""
        with self._lock:
            self.active = False
        self._stop.set()
        t = self._thread
        if t.is_alive() and t is not threading.current_thread():
            t.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.wait(self.policy.window_sec):
            try:
                if not self._tick():
                    return
            except Exception as e:  # noqa: BLE001 — the gate must not die
                log.error("rollout gate window failed: %s", e)

    def _arm_window(self, arm: str) -> ArmWindow:
        queries, errors, buckets = self.server.release_arm_snapshot(arm)
        b_queries, b_errors, b_buckets = self._baseline[arm]
        return ArmWindow(
            queries=int(queries - b_queries),
            errors=int(errors - b_errors),
            p99=window_quantile(b_buckets, buckets, 0.99))

    def _reset_baseline(self) -> None:
        self._baseline = {arm: self.server.release_arm_snapshot(arm)
                          for arm in (ARM_STABLE, ARM_CANDIDATE)}

    def _tick(self) -> bool:
        """One gate window; False when the rollout concluded."""
        with self._lock:
            if not self.active:
                return False
            stable = self._arm_window(ARM_STABLE)
            candidate = self._arm_window(ARM_CANDIDATE)
            decision = self.policy.evaluate(stable, candidate)
            self.windows += 1
            windows = self.windows
            self.last_decision = decision
            self.last_windows = {"stable": stable.to_json(),
                                 "candidate": candidate.to_json()}
            self._windows_total.labels(verdict=decision.action).inc()
        if decision.action == "rollback" and not self.shadow:
            self.rollback(decision.reason)
            return False
        if decision.action == "advance":
            if self.shadow:
                # record the healthy window; the operator promotes
                self.registry.record(
                    "shadow-window", self.instance_id, self.actor,
                    decision.reason, windows=windows)
                self._reset_baseline()
                return True
            nxt = self.policy.next_fraction(self.splitter.fraction)
            if nxt is None:
                self.promote(decision.reason)
                return False
            self.splitter.set_fraction(nxt)
            self._ramp_steps.inc()
            self.registry.set_fraction(nxt, self.actor, decision.reason)
            log.info("release %s ramped to %.0f%%: %s",
                     self.instance_id, nxt * 100, decision.reason)
            self._reset_baseline()
        # hold: the window stays open, the sample keeps accumulating
        return True

    # -- terminal transitions (also called by the operator routes) ----------
    def promote(self, reason: str) -> None:
        """The candidate becomes the pinned stable; the server rebinds
        it."""
        with self._lock:
            if not self.active:
                return
            self.active = False
            self.outcome = "promoted"
        self._stop.set()
        self.server.promote_candidate()
        self._promotions.inc()
        try:
            self.registry.promote(self.instance_id, self.actor, reason)
        except Exception as e:  # noqa: BLE001 — serving already switched
            log.error("release history write failed on promote: %s", e)
        log.info("release %s promoted to stable: %s",
                 self.instance_id, reason)

    def rollback(self, reason: str) -> None:
        """Unbind the candidate; stable keeps serving untouched."""
        with self._lock:
            if not self.active:
                return
            self.active = False
            self.outcome = "rolled_back"
        self._stop.set()
        self.server.drop_candidate()
        self._rollbacks.inc()
        try:
            self.registry.rollback(self.actor, reason)
        except Exception as e:  # noqa: BLE001 — candidate already gone
            log.error("release history write failed on rollback: %s", e)
        log.warning("release %s rolled back: %s", self.instance_id, reason)

    # -- observability ------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "active": self.active,
                "outcome": self.outcome,
                "candidateInstanceId": self.instance_id,
                "mode": "shadow" if self.shadow else "canary",
                "fraction": self.splitter.fraction,
                "windowsEvaluated": self.windows,
                "lastDecision": (self.last_decision.to_json()
                                 if self.last_decision else None),
                "lastWindows": self.last_windows,
                "policy": self.policy.to_json(),
            }
