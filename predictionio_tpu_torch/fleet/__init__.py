"""The fleet observability plane (the port's own copy of
``predictionio_tpu/fleet/``).

Makes N engine-server replicas legible as ONE system: a
:class:`FleetAggregator` scrapes every replica's full-fidelity
``/metrics.json`` and merges it exactly (counters sum, reset-compensated;
gauges gain per-replica labels plus min, max and sum rollups; histograms
add bucket by bucket, so every merged quantile is the pooled
population's). On top: a fleet-scoped SLO engine over the merged series,
cross-replica trace lookup, fleet-wide hot keys and capacity headroom
against a capacity model's knee. ``fleet serve`` (or ``deploy --fleet-of
N``) boots one.
"""

from .aggregator import (
    FleetAggregator,
    FleetConfig,
    build_fleet_app,
    create_fleet_server,
)

__all__ = [
    "FleetAggregator",
    "FleetConfig",
    "build_fleet_app",
    "create_fleet_server",
]
