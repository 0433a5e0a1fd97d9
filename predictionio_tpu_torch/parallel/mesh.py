"""Device meshes: which devices train and serve, and how a table's rows
split over them (the port of ``predictionio_tpu/parallel/mesh.py``).

A :class:`DeviceMesh` is an explicit list of devices laid out as a 2-D
grid with named axes: ``(data, model)`` for training (:func:`make_mesh`),
``(batch, model)`` for serving (:func:`make_serving_mesh`). A row-sharded
factor table spreads its rows over EVERY position of the mesh, in the
grid's row-major order (:func:`rows_spec`): shard ``s`` holds rows ``[s *
n_local, (s + 1) * n_local)`` on ``mesh.devices[s]``.

A mesh may span processes (``parallel/multihost.py::global_mesh``):
``ranks[s]`` is then the process that owns position ``s``, each process
holding a contiguous run of positions; a mesh with no ``ranks`` lives in
this process alone. Collectives over a one-process mesh are copies and
sums over its device list; over a process mesh they go through
``torch.distributed`` (``parallel/collectives.py``).

:func:`local_devices` is the port's ``jax.devices()``: every visible CUDA
card, or the CPU when asked for. ``PTPU_TORCH_FORCE_DEVICE_COUNT=N`` (off
by default, read only there) makes it list its first device N times, the
counterpart of the JAX package's
``--xla_force_host_platform_device_count``: N shards or N lanes on one
card (or on the CPU in the tests). Unset, one H100 is one device, and
:func:`resolve_serving_mode` resolves as the JAX package does on one chip.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from ..utils.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
BATCH_AXIS = "batch"

#: serving-mode names (``ServerConfig.serving_mode`` / ``deploy
#: --serving-mode``): "single" is the one-device path, "replicated" holds
#: a full model copy per device and fans micro-batches out across
#: per-device lanes, "sharded" row-shards the factor tables over the
#: whole mesh (tables bigger than one card's memory), "auto" picks by the
#: card's memory
SERVING_MODES = ("auto", "single", "replicated", "sharded")

#: share of one device's memory a model may occupy before "auto" switches
#: from replicated to sharded: factors are not the only resident bytes
#: (serving temporaries, the pinned hot tier), so a full copy per device
#: needs headroom
AUTO_SHARD_HBM_FRACTION = 0.6

#: the environment variable :func:`local_devices` reads (off by default)
FORCE_DEVICE_COUNT_ENV = "PTPU_TORCH_FORCE_DEVICE_COUNT"


def local_devices(device: DeviceLike = None) -> List[torch.device]:
    """The devices this process serves on: every visible CUDA card (the
    asked-for one first; the card by default), or ``[cpu]`` when the CPU
    is asked for. With ``PTPU_TORCH_FORCE_DEVICE_COUNT=N`` the first
    device N times instead."""
    first = resolve_device(device)
    devices = [first]
    if first.type == "cuda":
        devices += [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())
                    if i != first.index]
    forced = os.environ.get(FORCE_DEVICE_COUNT_ENV, "").strip()
    if forced:
        n = int(forced)
        if n < 1:
            raise ValueError(f"{FORCE_DEVICE_COUNT_ENV} must be >= 1, "
                             f"got {forced!r}")
        devices = [first] * n
    return devices


@dataclass(frozen=True)
class DeviceMesh:
    """Devices laid out as a 2-D grid with named axes. ``devices`` is
    the grid flattened row-major; a device may repeat (several shards or
    lanes on one card). ``ranks`` is empty for a mesh of this process
    alone, else the owning process of each position (a position of
    another process names that process's device)."""

    devices: Tuple[torch.device, ...]
    shape: Tuple[int, int]
    axis_names: Tuple[str, str] = (BATCH_AXIS, MODEL_AXIS)
    ranks: Tuple[int, ...] = ()

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    @property
    def spans_processes(self) -> bool:
        """Whether collectives over this mesh go through
        ``torch.distributed`` (a mesh from ``global_mesh``)."""
        return bool(self.ranks)

    def local_positions(self, rank: Optional[int] = None) -> Tuple[int, ...]:
        """The positions process ``rank`` owns (this process by default):
        every position of a one-process mesh."""
        if not self.ranks:
            return tuple(range(self.size))
        if rank is None:
            from .multihost import process_index

            rank = process_index()
        return tuple(p for p, r in enumerate(self.ranks) if r == rank)

    def coords(self, position: int) -> Tuple[int, int]:
        """The grid coordinates of a flat position."""
        return divmod(position, self.shape[1])


def _build_mesh(shape, names, devices) -> DeviceMesh:
    if devices is None:
        devices = local_devices()
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    d0, d1 = shape
    if d0 is None:
        if n % d1 != 0:
            raise ValueError(f"{n} devices not divisible by "
                             f"{names[1]}={d1}")
        d0 = n // d1
    if d0 * d1 > n:
        raise ValueError(f"mesh {d0}x{d1} needs {d0 * d1} devices, "
                         f"have {n}")
    return DeviceMesh(tuple(devices[: d0 * d1]), (d0, d1), names)


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence[torch.device]] = None
              ) -> DeviceMesh:
    """The 2-D ``(data, model)`` TRAINING mesh over ``devices`` (every
    device of :func:`local_devices` on the data axis by default). A mesh
    of one device is the single-device path."""
    return _build_mesh((data, model), (DATA_AXIS, MODEL_AXIS), devices)


def make_serving_mesh(batch: Optional[int] = None, model: int = 1,
                      devices: Optional[Sequence[torch.device]] = None
                      ) -> DeviceMesh:
    """The 2-D ``(batch, model)`` SERVING mesh. Default: every device of
    :func:`local_devices` on the batch axis. The row-sharded layout
    (:func:`rows_spec`) spreads rows over both axes, so the split between
    them matters only to code that addresses one axis."""
    return _build_mesh((batch, model), (BATCH_AXIS, MODEL_AXIS), devices)


def rows_spec(mesh: Optional[DeviceMesh]) -> Tuple[str, ...]:
    """The axes a table's rows split over: EVERY axis of ``mesh``, in
    order (the JAX package's ``P(tuple(mesh.axis_names))``); ``()`` (one
    whole table) without a mesh."""
    if mesh is None:
        return ()
    return tuple(mesh.axis_names)


def single_device_mesh(device: DeviceLike = None) -> DeviceMesh:
    """A 1 x 1 training mesh over the first local device (of
    :func:`local_devices`, the card by default)."""
    return make_mesh(data=1, model=1, devices=local_devices(device)[:1])


def data_sharding(mesh: DeviceMesh, ndim: int = 1) -> Tuple[str, ...]:
    """The leading dimension split over the data axis, the rest whole."""
    return (DATA_AXIS,)


def model_sharding(mesh: DeviceMesh, ndim: int = 2) -> Tuple[str, ...]:
    """The leading dimension split over the model axis (factor rows)."""
    return (MODEL_AXIS,)


def replicated(mesh: Optional[DeviceMesh]) -> Tuple[str, ...]:
    """A whole copy on every position."""
    return ()


@contextmanager
def maybe_mesh(mesh: Optional[DeviceMesh]) -> Iterator[Optional[DeviceMesh]]:
    """The JAX package enters ``mesh`` as the ambient sharding context
    here. The port has no ambient mesh: every function that lays out
    over one takes it as an argument, so this yields ``mesh`` (None for
    the one device) and sets nothing."""
    yield mesh


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of ``k`` that is >= ``n`` (shard-even padding)."""
    return ((n + k - 1) // k) * k


def device_hbm_bytes(device: DeviceLike = None) -> Optional[int]:
    """One device's memory in bytes (the card's ``total_memory``); None
    for the CPU or where it cannot be read: callers treat None as "sizing
    unknown", never as "infinite"."""
    try:
        dev = resolve_device(device)
        if dev.type != "cuda":
            return None
        return int(torch.cuda.get_device_properties(dev).total_memory) \
            or None
    except Exception:  # noqa: BLE001 — sizing is advisory
        return None


def resolve_serving_mode(mode: str, model_bytes: Optional[int],
                         n_devices: int,
                         hbm_limit: Optional[int] = None,
                         headroom: float = AUTO_SHARD_HBM_FRACTION) -> str:
    """The concrete serving mode for ``ServerConfig.serving_mode``.

    ``auto``: a model whose resident factor bytes exceed ``headroom`` x
    one device's memory cannot keep a full copy per device beside the
    serving temporaries -> ``sharded``; otherwise N devices each take a
    full copy -> ``replicated``; one device stays ``single``, and an
    unsized model or device never shards."""
    if mode not in SERVING_MODES:
        raise ValueError(f"serving_mode must be one of {SERVING_MODES}, "
                         f"got {mode!r}")
    if mode != "auto":
        return mode
    if n_devices <= 1:
        return "single"
    if hbm_limit is None:
        hbm_limit = device_hbm_bytes()
    if model_bytes is not None and hbm_limit is not None \
            and model_bytes > headroom * hbm_limit:
        return "sharded"
    return "replicated"
