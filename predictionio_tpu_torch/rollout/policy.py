"""The release health gate: candidate vs. stable over a sliding window
(the port's own copy of ``predictionio_tpu/rollout/policy.py``).

The caller feeds :meth:`HealthPolicy.evaluate` one :class:`ArmWindow` per
arm and the policy answers ``advance`` / ``hold`` / ``rollback``. Two
callers: the :class:`~.controller.RolloutController`, whose windows are
deltas of the engine server's per-arm release series (p99 through
:func:`window_quantile`), and the stream trainer's fold-in canary, which
probes the folded model against the serving one. The ramp schedule and
the window length live here, so the controller, the ``release`` CLI and
the tests share one definition.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from ..obs.histogram import window_quantile

__all__ = ["ArmWindow", "Decision", "HealthPolicy", "DEFAULT_RAMP",
           "window_quantile"]

#: The default promotion ladder: 1% -> 5% -> 25% -> 100%.
DEFAULT_RAMP: Tuple[float, ...] = (0.01, 0.05, 0.25, 1.0)


@dataclass(frozen=True)
class ArmWindow:
    """What one arm did inside the current evaluation window."""

    queries: int = 0
    errors: int = 0
    p99: Optional[float] = None  # seconds; None below min sample

    @property
    def error_rate(self) -> float:
        return self.errors / self.queries if self.queries else 0.0

    def to_json(self) -> dict:
        return {"queries": self.queries, "errors": self.errors,
                "errorRate": round(self.error_rate, 4),
                "p99Sec": self.p99}


@dataclass(frozen=True)
class Decision:
    """The gate's verdict for one window."""

    action: str  # "advance" | "hold" | "rollback"
    reason: str

    def to_json(self) -> dict:
        return {"action": self.action, "reason": self.reason}


@dataclass(frozen=True)
class HealthPolicy:
    """Gate thresholds and ramp schedule (windows are wall-clock)."""

    #: Candidate traffic fractions walked on consecutive healthy
    #: windows; reaching the final step promotes.
    ramp: Sequence[float] = DEFAULT_RAMP
    #: Seconds per evaluation window.
    window_sec: float = 30.0
    #: Candidate queries required before the gate judges (an idle
    #: canary holds, it neither promotes nor rolls back).
    min_queries: int = 20
    #: Absolute candidate error-rate ceiling.
    max_error_rate: float = 0.05
    #: Candidate error rate may exceed stable's by at most this much
    #: (catches "stable is also erroring" baselines).
    error_rate_slack: float = 0.02
    #: Candidate p99 must stay under stable p99 × this multiple
    #: (only judged when both arms have a full sample).
    p99_regression: float = 2.0

    def next_fraction(self, fraction: float) -> Optional[float]:
        """The ramp step after ``fraction``; None when the ladder is
        exhausted (the next healthy window promotes)."""
        for step in self.ramp:
            if step > fraction + 1e-9:
                return step
        return None

    def evaluate(self, stable: ArmWindow,
                 candidate: ArmWindow) -> Decision:
        if candidate.queries < self.min_queries:
            return Decision(
                "hold",
                f"insufficient candidate sample "
                f"({candidate.queries}/{self.min_queries} queries)")
        if candidate.error_rate > self.max_error_rate:
            return Decision(
                "rollback",
                f"candidate error rate {candidate.error_rate:.3f} "
                f"exceeds ceiling {self.max_error_rate:.3f} "
                f"({candidate.errors}/{candidate.queries})")
        if stable.queries >= self.min_queries and \
                candidate.error_rate > (stable.error_rate
                                        + self.error_rate_slack):
            return Decision(
                "rollback",
                f"candidate error rate {candidate.error_rate:.3f} "
                f"exceeds stable {stable.error_rate:.3f} + slack "
                f"{self.error_rate_slack:.3f}")
        if (candidate.p99 is not None and stable.p99 is not None
                and stable.queries >= self.min_queries
                and stable.p99 > 0
                and candidate.p99 > stable.p99 * self.p99_regression):
            return Decision(
                "rollback",
                f"candidate p99 {candidate.p99 * 1000:.1f}ms exceeds "
                f"stable {stable.p99 * 1000:.1f}ms × "
                f"{self.p99_regression:g}")
        return Decision(
            "advance",
            f"healthy window: {candidate.queries} queries, error rate "
            f"{candidate.error_rate:.3f}")

    def to_json(self) -> dict:
        return {"ramp": list(self.ramp), "windowSec": self.window_sec,
                "minQueries": self.min_queries,
                "maxErrorRate": self.max_error_rate,
                "errorRateSlack": self.error_rate_slack,
                "p99Regression": self.p99_regression}
