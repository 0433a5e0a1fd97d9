"""Service-level objectives: burn-rate accounting and the capacity gate
(the port's own copy of ``predictionio_tpu/slo/``).

:class:`SLOSpec` declares what the service promises, :class:`SLOEngine`
accounts the promise against the live ``pio_*`` telemetry with
multi-window error-budget burn rates (every engine server runs one by
default, and the fleet aggregator one over the merged series), and
:mod:`.gate` turns a measured capacity model into a merge gate with
ratchet semantics.
"""

from .engine import SLOEngine
from .gate import GATE_KEYS, gate_capacity, ratchet_gates, write_gates
from .spec import OBJECTIVES, SLOSpec, default_specs, load_specs

__all__ = [
    "GATE_KEYS",
    "OBJECTIVES",
    "SLOEngine",
    "SLOSpec",
    "default_specs",
    "gate_capacity",
    "load_specs",
    "ratchet_gates",
    "write_gates",
]
