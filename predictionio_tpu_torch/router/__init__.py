"""The SLO-driven autoscaling tier (the port's own copy of
``predictionio_tpu/router/``). Three cooperating pieces turn a static
``deploy --fleet-of N`` into an elastic fleet:

- :class:`QueryRouter`: consistent-hash entity affinity over a
  :class:`HashRing` (sha256-keyed like the serving cache, so per-replica
  hit rates survive membership changes), with Space-Saving-confirmed
  hot-key spill, health ejection and bounded retry;
- :class:`ReplicaLifecycle`: the spawn, warm, ready, drain, terminate
  state machine (warm gates on ``pio_serving_warm``; drain stops new
  assignments and lets in-flight work finish);
- :class:`Autoscaler`: the control loop: out on a fast-window SLO burn
  or low capacity headroom, in against the capacity model's knee with
  hysteresis and a cooldown, every decision traced and logged on
  ``/fleet.json``.
"""

from .autoscaler import Autoscaler, AutoscalePolicy
from .lifecycle import ReplicaLifecycle
from .ring import HashRing, key_point
from .router import (
    QueryRouter,
    RouterConfig,
    build_router_app,
    create_router_server,
)

__all__ = [
    "Autoscaler",
    "AutoscalePolicy",
    "HashRing",
    "QueryRouter",
    "ReplicaLifecycle",
    "RouterConfig",
    "build_router_app",
    "create_router_server",
    "key_point",
]
