"""Parallelism: the serving mesh and its one collective (the serving part
of ``predictionio_tpu/parallel``). The training collectives, multi-host
start-up and the training mesh are not in this package yet
(``ROADMAP.md`` queue 1)."""

from .collectives import merge_candidates, sharded_top_k
from .mesh import (
    AUTO_SHARD_HBM_FRACTION,
    BATCH_AXIS,
    DATA_AXIS,
    FORCE_DEVICE_COUNT_ENV,
    MODEL_AXIS,
    SERVING_MODES,
    ServingMesh,
    device_hbm_bytes,
    local_devices,
    make_serving_mesh,
    pad_to_multiple,
    resolve_serving_mode,
    rows_spec,
)

__all__ = [
    "AUTO_SHARD_HBM_FRACTION",
    "BATCH_AXIS",
    "DATA_AXIS",
    "FORCE_DEVICE_COUNT_ENV",
    "MODEL_AXIS",
    "SERVING_MODES",
    "ServingMesh",
    "device_hbm_bytes",
    "local_devices",
    "make_serving_mesh",
    "merge_candidates",
    "pad_to_multiple",
    "resolve_serving_mode",
    "rows_spec",
    "sharded_top_k",
]
