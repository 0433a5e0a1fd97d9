"""The health gate: candidate vs. stable over one window (the port's
own copy of ``ArmWindow``, ``Decision`` and ``HealthPolicy.evaluate``
from ``predictionio_tpu/rollout/policy.py``).

The caller builds one :class:`ArmWindow` per arm and
:meth:`HealthPolicy.evaluate` answers ``advance`` / ``hold`` /
``rollback``. In the port the stream trainer's canary is the caller: it
probes the folded model against the serving one. The release
controller, with its ramp schedule, windows and ``window_quantile``,
waits for ``rollout/`` and ``obs/`` (``ROADMAP.md`` queue 1 items 5 and
10).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

__all__ = ["ArmWindow", "Decision", "HealthPolicy"]


@dataclass(frozen=True)
class ArmWindow:
    """What one arm did inside the current evaluation window."""

    queries: int = 0
    errors: int = 0
    p99: Optional[float] = None  # seconds; None below min sample

    @property
    def error_rate(self) -> float:
        return self.errors / self.queries if self.queries else 0.0


@dataclass(frozen=True)
class Decision:
    """The gate's verdict for one window."""

    action: str  # "advance" | "hold" | "rollback"
    reason: str


@dataclass(frozen=True)
class HealthPolicy:
    """Gate thresholds."""

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
