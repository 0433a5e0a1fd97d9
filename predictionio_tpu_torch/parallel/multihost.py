"""Several processes as one training system (the port of
``predictionio_tpu/parallel/multihost.py``).

Every process runs the same program. :func:`initialize_distributed` joins
them into one ``torch.distributed`` process group over a ``tcp://``
rendezvous (``PIO_COORDINATOR``, ``PIO_NUM_PROCESSES``,
``PIO_PROCESS_ID``, as the JAX package reads them), and each process
feeds its own shard of the data. The backend is named, never guessed
after a failure: NCCL by default where CUDA is present, gloo on the CPU;
``backend=`` or ``PIO_DIST_BACKEND`` overrides it. NCCL takes one card a
rank, so two ranks on one card must ask for gloo: the start-up refuses
such a group under NCCL rather than fail inside the first collective.
Each rank's card is ``LOCAL_RANK % device_count`` (``LOCAL_RANK`` falls
back to the process id).

Beside the device group there is always a gloo group on the host: the
host collectives below move numpy arrays through it as raw bytes (the
dtype survives exactly), whatever the device backend. They are the
shuffle the sharded training read rides (``exchange_filtered``), the
count agreement that gives every process the same id indexation
(``allreduce_sum``), the engine-instance id a single writer mints
(``broadcast_str``) and the checkpoint's commit fence (``barrier``).
Every one fires the ``multihost.collective`` fault point with ``op=``
naming it; so do the device collectives of ``parallel/collectives.py``.

All of them are collective: every process calls them at the same point
with same-shaped inputs. A process group of one still goes through
``torch.distributed`` once it is initialized; without a group each is
the identity.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..faults import declare, fire
from .mesh import FORCE_DEVICE_COUNT_ENV, DeviceMesh, local_devices

log = logging.getLogger(__name__)

F_COLLECTIVE = declare(
    "multihost.collective",
    "entry of a cross-process collective (host: allgather/broadcast/"
    "barrier; device: the mesh collectives); op= label names which")

#: the backend names ``initialize_distributed`` accepts
BACKENDS = ("nccl", "gloo")

_host_group = None
_backend: Optional[str] = None

#: device collectives that went through host memory, and the bytes they
#: gathered: gloo is a CPU library, so a CUDA tensor handed to it is
#: copied through the host inside the backend. ``collectives.
#: gather_positions`` counts each one, and ``ring_permute`` each block it
#: stages itself (gloo's send and receive take CPU tensors only); NCCL's
#: never are.
HOST_STAGED = {"collectives": 0, "bytes": 0}

#: blocks ``collectives.ring_permute`` received point to point from
#: another process, and their bytes
P2P_RECEIVED = {"messages": 0, "bytes": 0}


def fire_collective(op: str, **labels) -> None:
    fire(F_COLLECTIVE, op=op, **labels)


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return _dist().get_rank() if is_initialized() else 0


def process_count() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def backend() -> Optional[str]:
    """The device group's backend ("nccl" or "gloo"), None without one."""
    return _backend if is_initialized() else None


def device_group():
    """The process group the device collectives use (the default one)."""
    return _dist().group.WORLD


def host_group():
    """The gloo group the host collectives use: the default group when
    its backend is gloo, else one made beside it at start-up."""
    return _host_group if _host_group is not None else device_group()


def _resolve_backend(backend_arg: Optional[str]) -> str:
    name = backend_arg or os.environ.get("PIO_DIST_BACKEND") or \
        ("nccl" if torch.cuda.is_available() else "gloo")
    name = name.lower()
    if name not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {name!r}")
    if name == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("backend 'nccl' needs CUDA; this process has "
                           "none (use backend='gloo')")
    return name


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Join the process group (a no-op without a coordinator and a
    process count, or when already joined).

    Arguments fall back to ``PIO_COORDINATOR`` (``host:port``),
    ``PIO_NUM_PROCESSES`` and ``PIO_PROCESS_ID``; ``backend`` to
    ``PIO_DIST_BACKEND``, then NCCL where CUDA is present and gloo
    elsewhere. Under NCCL a rank takes card ``LOCAL_RANK %
    device_count`` before the group forms, and two ranks of one host on
    one card are refused: NCCL takes one card a rank, so such ranks need
    gloo, asked for by name."""
    global _host_group, _backend

    if is_initialized():
        return
    coordinator = coordinator_address or os.environ.get("PIO_COORDINATOR")
    n = num_processes if num_processes is not None else \
        int(os.environ.get("PIO_NUM_PROCESSES", "0") or 0) or None
    pid = process_id if process_id is not None else \
        int(os.environ.get("PIO_PROCESS_ID", "-1") or -1)
    if coordinator is None and n is None:
        return
    if coordinator is None or n is None or pid < 0:
        raise ValueError(
            f"a process group needs a coordinator, a process count and "
            f"this process's id: got {coordinator!r}, {n!r}, {pid!r}")
    name = _resolve_backend(backend)
    dist = _dist()
    if torch.cuda.is_available():
        raw = os.environ.get("LOCAL_RANK")
        lr = int(raw) if raw not in (None, "") else pid
        torch.cuda.set_device(lr % torch.cuda.device_count())
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend=name, init_method=init, world_size=n,
                            rank=pid)
    _backend = name
    _host_group = None if name == "gloo" else dist.new_group(
        backend="gloo")
    log.info("joined process group: rank %d of %d, backend %s", pid, n,
             name)
    if name == "nccl":
        _refuse_shared_cards()


def _refuse_shared_cards() -> None:
    """NCCL takes one card a rank: refuse a group where two ranks of one
    host hold the same card."""
    import socket

    me = f"{socket.gethostname()}:{torch.cuda.current_device()}"
    mine = np.frombuffer(me.encode("utf-8").ljust(256, b"\0"), np.uint8)
    seen = [bytes(p).rstrip(b"\0").decode("utf-8")
            for p in _allgather_parts(mine)]
    if len(set(seen)) != len(seen):
        shutdown()
        raise RuntimeError(
            f"backend 'nccl' with two ranks on one card ({seen}); ranks "
            f"that share a card need backend='gloo' (PIO_DIST_BACKEND)")


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _host_group, _backend

    if is_initialized():
        _dist().destroy_process_group()
    _host_group = None
    _backend = None


def barrier(tag: str) -> None:
    """Rendezvous every process at ``tag`` (a no-op without a group): the
    distributed checkpointer's commit fence."""
    if not is_initialized():
        return
    fire_collective("barrier", tag=tag)
    _dist().barrier(group=host_group())


def global_mesh(data: Optional[int] = None, model: int = 1,
                device=None) -> DeviceMesh:
    """A ``(data, model)`` mesh over every process's devices, in rank
    order, each position recording its owner. A process's device is
    ``device`` (its own card by default; ``"cpu"``), repeated
    ``PTPU_TORCH_FORCE_DEVICE_COUNT`` times when that is set, as
    :func:`~.mesh.local_devices` does. Without a process group it is
    ``make_mesh``'s mesh of this process's devices."""
    if not is_initialized():
        from .mesh import make_mesh

        return make_mesh(data=data, model=model,
                         devices=local_devices(device))
    mine = local_devices(device)
    if not os.environ.get(FORCE_DEVICE_COUNT_ENV, "").strip():
        mine = mine[:1]  # a rank trains on its own card
    desc = np.array([len(mine)] + [d.index if d.index is not None else -1
                                   for d in mine], np.int64)
    counts = _allgather_parts(np.array([len(desc)], np.int64))
    width = int(max(int(c[0]) for c in counts))
    padded = np.full(width, -2, np.int64)
    padded[:len(desc)] = desc
    devices: List[torch.device] = []
    ranks: List[int] = []
    for rank, part in enumerate(_allgather_parts(padded)):
        k = int(part[0])
        for idx in part[1:1 + k]:
            devices.append(torch.device(mine[0].type, int(idx))
                           if idx >= 0 else torch.device(mine[0].type))
            ranks.append(rank)
    for k, p in enumerate(p for p, r in enumerate(ranks)
                          if r == process_index()):
        devices[p] = mine[k]
    n = len(devices)
    d1 = model
    d0 = data if data is not None else n // d1
    if d0 * d1 != n:
        raise ValueError(f"a global mesh {d0}x{d1} needs {d0 * d1} "
                         f"devices; the processes have {n}")
    return DeviceMesh(tuple(devices), (d0, d1), ("data", "model"),
                      tuple(ranks))


def host_shard_bounds(size: int) -> Tuple[int, int]:
    """``(start, stop)`` of this process's contiguous slice of a
    host-global axis of ``size``."""
    n = process_count()
    i = process_index()
    per = (size + n - 1) // n
    start = min(i * per, size)
    return start, min(start + per, size)


def host_shard(array: np.ndarray, *, axis: int = 0) -> np.ndarray:
    """This process's contiguous slice of a host-global array."""
    start, stop = host_shard_bounds(array.shape[axis])
    return np.take(array, np.arange(start, stop), axis=axis)


def from_process_local(local, mesh: DeviceMesh) -> List[torch.Tensor]:
    """This process's blocks of a row-sharded array from its local part
    (``[d_loc, ...]``, one leading entry a local position, in mesh
    order), each on its position's device: the port's
    ``make_array_from_process_local_data``."""
    positions = mesh.local_positions()
    t = torch.as_tensor(np.ascontiguousarray(local))
    if t.shape[0] != len(positions):
        raise ValueError(f"{t.shape[0]} local blocks for the "
                         f"{len(positions)} positions this process owns")
    return [t[k].to(mesh.devices[p]) for k, p in enumerate(positions)]


# -- host collectives --------------------------------------------------------


def _allgather_parts(x: np.ndarray) -> list:
    """Collective: every process's same-shaped ``x``, in process order,
    dtype preserved exactly (raw bytes over the host group)."""
    x = np.ascontiguousarray(x)
    if not is_initialized():
        return [x]
    fire_collective("allgather")
    dist = _dist()
    group = host_group()
    raw = torch.from_numpy(x.view(np.uint8).reshape(-1).copy())
    parts = [torch.empty_like(raw)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, raw, group=group)
    return [p.numpy().view(x.dtype).reshape(x.shape) for p in parts]


def broadcast_str(s: str, max_len: int = 256) -> str:
    """Collective: process 0's string to everyone (the engine-instance id
    a single-writer workflow mints on process 0)."""
    if not is_initialized():
        return s
    fire_collective("broadcast")
    buf = np.zeros(max_len, np.uint8)
    b = s.encode("utf-8")[:max_len]
    buf[:len(b)] = np.frombuffer(b, np.uint8)
    t = torch.from_numpy(buf)
    _dist().broadcast(t, src=0, group=host_group())
    out = t.numpy()
    return bytes(out[out != 0]).decode("utf-8")


def allreduce_sum(x: np.ndarray) -> np.ndarray:
    """Collective element-wise sum across processes, in process order:
    the per-code count agreement that gives every process the same
    factor-row indexation from its own storage shard."""
    parts = _allgather_parts(np.ascontiguousarray(x))
    if len(parts) == 1:
        return parts[0]
    return np.sum(parts, axis=0, dtype=x.dtype)


def exchange_filtered(arrays: Sequence[np.ndarray], keep,
                      chunk: int = 4_000_000) -> list:
    """Collective shuffle with bounded memory: every process contributes
    parallel 1-D ``arrays`` (its local rows, any length; lengths may
    differ across processes) and receives the union of every process's
    rows where ``keep(*column_chunks)`` is True. Rounds are fixed-size
    (``chunk`` rows, padded), so the transient memory is ``n_proc x
    chunk`` rows plus the kept output, never the whole log.

    The order is not guaranteed: the output is round-interleaved (``[p0
    chunk0, p1 chunk0, ..., p0 chunk1, ...]``), so a caller that needs a
    deterministic order carries a position column through and sorts on
    it afterwards (as ``ShardedColumnarRatingsSource`` does).

    Returns the kept columns as concatenated arrays (same order and
    dtypes as ``arrays``)."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    n_local = len(arrays[0])
    if any(len(a) != n_local for a in arrays):
        raise ValueError("exchange_filtered takes parallel arrays")
    if not is_initialized():
        m = keep(*arrays)
        return [a[m] for a in arrays]
    lens = _allgather_parts(np.asarray([n_local], dtype=np.int64))
    rounds = int(max(int(p[0]) for p in lens) + chunk - 1) // chunk
    outs: list = [[] for _ in arrays]
    for r in range(rounds):
        lo = r * chunk
        padded = []
        for a in arrays:
            part = a[lo:lo + chunk]
            if len(part) < chunk:
                part = np.concatenate(
                    [part, np.zeros(chunk - len(part), dtype=a.dtype)])
            padded.append(part)
        gathered = [_allgather_parts(p) for p in padded]
        for p in range(len(lens)):
            valid = min(max(int(lens[p][0]) - lo, 0), chunk)
            if valid == 0:
                continue
            cols = [g[p][:valid] for g in gathered]
            m = keep(*cols)
            for o, c in zip(outs, cols):
                o.append(c[m])
    return [np.concatenate(o) if o else np.empty(0, dtype=a.dtype)
            for o, a in zip(outs, arrays)]
