"""Parallelism: device meshes, the collectives over them and several
processes as one system (the port of ``predictionio_tpu/parallel``).

A mesh is an explicit grid of devices; a sharding spec is the tuple of
mesh axes a tensor's leading dimension splits over (``()`` replicated),
the port's ``PartitionSpec``."""

from .collectives import (
    all_gather,
    all_reduce_sum,
    axis_index,
    gramian_allreduce,
    merge_candidates,
    reduce_scatter,
    ring_permute,
    shard_map_compat,
    sharded,
    sharded_top_k,
)
from .mesh import (
    AUTO_SHARD_HBM_FRACTION,
    BATCH_AXIS,
    DATA_AXIS,
    FORCE_DEVICE_COUNT_ENV,
    MODEL_AXIS,
    SERVING_MODES,
    DeviceMesh,
    data_sharding,
    device_hbm_bytes,
    local_devices,
    make_mesh,
    make_serving_mesh,
    model_sharding,
    pad_to_multiple,
    replicated,
    resolve_serving_mode,
    rows_spec,
    single_device_mesh,
)
from .multihost import (
    from_process_local,
    global_mesh,
    host_shard,
    initialize_distributed,
)


__all__ = [
    "all_gather",
    "all_reduce_sum",
    "axis_index",
    "gramian_allreduce",
    "merge_candidates",
    "reduce_scatter",
    "ring_permute",
    "sharded",
    "sharded_top_k",
    "from_process_local",
    "global_mesh",
    "host_shard",
    "initialize_distributed",
    "AUTO_SHARD_HBM_FRACTION",
    "BATCH_AXIS",
    "DATA_AXIS",
    "FORCE_DEVICE_COUNT_ENV",
    "MODEL_AXIS",
    "SERVING_MODES",
    "DeviceMesh",
    "data_sharding",
    "device_hbm_bytes",
    "local_devices",
    "make_mesh",
    "make_serving_mesh",
    "model_sharding",
    "pad_to_multiple",
    "replicated",
    "resolve_serving_mode",
    "rows_spec",
    "shard_map_compat",
    "single_device_mesh",
]
