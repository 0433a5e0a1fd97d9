"""Progressive delivery (the port of ``predictionio_tpu/rollout/``):
versioned releases, canary and shadow traffic, health-gated promotion
and rollback.

- :mod:`.registry`: the release registry over engine-instance metadata
  (pin, promote, rollback, history), a JSON blob in the MODELDATA repo
  that the JAX package reads and writes the same way.
- :mod:`.splitter`: hash-of-entity cohorts route a fraction of queries to
  a candidate bound beside the stable release, or mirror them to it
  (shadow).
- :mod:`.policy`: the health gate (error rate and p99 over a window), also
  the stream trainer's fold-in canary.
- :mod:`.controller`: the loop that ramps a healthy candidate, promotes
  it to the pinned stable, or rolls an unhealthy one back.

Wired through ``cli release {list,show,pin,status,canary,promote,
rollback}`` and the engine server's ``/reload``, ``/release.json`` and
``/release/{canary,promote,rollback}`` routes.
"""

from .controller import RolloutController
from .policy import ArmWindow, Decision, HealthPolicy, window_quantile
from .registry import ReleaseEvent, ReleaseRegistry
from .splitter import TrafficSplitter, cohort_bucket

__all__ = [
    "ArmWindow",
    "Decision",
    "HealthPolicy",
    "ReleaseEvent",
    "ReleaseRegistry",
    "RolloutController",
    "TrafficSplitter",
    "cohort_bucket",
    "window_quantile",
]
