"""Collectives over a device mesh (the port of
``predictionio_tpu/parallel/collectives.py``).

The JAX package writes a collective inside a ``shard_map``: the body runs
once per device and ``lax.psum`` / ``all_gather`` / ``ppermute`` join
them. The port has no SPMD tracer, so a collective here takes the
per-shard blocks themselves: a list with one tensor per position of the
mesh that this process owns, in mesh order, and returns one tensor per
position, each on that position's device.

- Over a mesh of this process alone (``make_mesh``) every position is
  local, and a collective is copies and sums over the device list: a sum
  adds the shards in position order, so its rounding is fixed.
- Over a process mesh (``multihost.global_mesh``) the list holds this
  process's positions, and the blocks of the others come through
  ``torch.distributed`` (:func:`gather_positions`): every position's
  block reaches every process, which then reduces in position order, so
  every process computes the same bits. Under NCCL the blocks travel
  card to card. gloo accepts CUDA tensors for ``all_gather`` but is a
  CPU library: it copies them through host memory inside the backend,
  and each such collective and its gathered bytes are counted in
  ``multihost.HOST_STAGED``.

Results for positions that share a device are one tensor, made once:
four shards on one card read one gathered table, not four copies.

:func:`record_collectives` is the port's collective census (the JAX
package reads the collectives of compiled HLO; here they are calls). Off
by default, a collective then costs one branch on :data:`_recorder`. On,
each public collective called from the recording thread is recorded once
a call under its HLO op name, with its per-position result shape in the
HLO style (``f32[16,16]``): ``all_reduce_sum`` and ``gramian_allreduce``
as ``all-reduce``; ``all_gather`` and the join of a :func:`sharded`
out-spec as ``all-gather``; ``reduce_scatter`` as ``reduce-scatter``;
``ring_permute`` as ``collective-permute``; ``merge_candidates`` as two
``all-gather`` records, the scores and the ids. A collective another one
calls is not recorded again, and a process mesh's ``torch.distributed``
traffic counts as the call that made it, so a process mesh and a
one-process mesh record the same census. With ``positions=True`` the
recorder also keeps which mesh position each block belongs to
(:func:`tag_position`, called where the mesh helpers cut blocks), for
``analysis/hlo_audit.py`` to find the moves between positions that go
through no collective.

:func:`ring_permute` is the exception to "every block reaches every
process": over a process mesh each block goes to its ring neighbour
alone, point to point (``torch.distributed.batch_isend_irecv``), so a
ring holds one block a position, never all P. gloo sends CPU tensors
only: a CUDA block is staged through host memory explicitly and counted
in ``multihost.HOST_STAGED``; every block received from another process
is counted in ``multihost.P2P_RECEIVED``.

:func:`sharded_top_k` and :func:`merge_candidates` are the serving
collective: the global top-k of row-sharded candidates, merged in the
serving kernel's own total order (score descending, then id ascending).
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import (Callable, Dict, FrozenSet, Iterator, List, Optional,
                    Sequence, Tuple, Union)

import torch

from ..ops.fused_topk import merge_partial_topk
from .mesh import MODEL_AXIS, DeviceMesh

Axis = Union[str, Sequence[str]]


# -- the collective census ----------------------------------------------------

#: torch dtypes by their HLO names
_HLO_DTYPES = {
    torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int8: "s8", torch.int16: "s16",
    torch.int32: "s32", torch.int64: "s64", torch.uint8: "u8",
    torch.bool: "pred",
}


def hlo_shape(t: torch.Tensor) -> str:
    """``t``'s dtype and shape as HLO prints a result, the layout
    dropped: ``f32[16,16]``, ``s32[4,8]``, ``f32[]``."""
    dt = _HLO_DTYPES.get(t.dtype, str(t.dtype).replace("torch.", ""))
    return f"{dt}[{','.join(str(n) for n in t.shape)}]"


class Placement:
    """Which mesh positions' blocks each storage's bytes hold: byte
    ranges of a storage, each with its positions. Keyed on the storage,
    since the positions of a mesh on one device share that device, and
    held by a weak reference, so a freed storage's key is never reused
    while the entry is kept."""

    def __init__(self):
        self._ranges: Dict[int, Tuple[object, Dict[Tuple[int, int],
                                                    FrozenSet[int]]]] = {}

    @staticmethod
    def span(t: torch.Tensor):
        """``(storage, first byte, end byte)`` of the bytes ``t`` views,
        or None for an empty tensor."""
        if t.numel() == 0:
            return None
        size = t.element_size()
        lo = t.storage_offset() * size
        extent = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
        return t.untyped_storage(), lo, lo + extent * size

    def of(self, t: torch.Tensor) -> FrozenSet[int]:
        """The positions whose bytes ``t`` reads."""
        span = self.span(t)
        if span is None:
            return frozenset()
        st, lo, hi = span
        ent = self._ranges.get(st._cdata)
        if ent is None:
            return frozenset()
        out: FrozenSet[int] = frozenset()
        for (a, b), ps in ent[1].items():
            if a < hi and lo < b:
                out |= ps
        return out

    def add(self, t: torch.Tensor, positions: FrozenSet[int],
            replace: bool = False) -> None:
        """``positions`` onto the bytes ``t`` views (in place of what they
        held with ``replace``)."""
        span = self.span(t)
        if span is None or not positions:
            return
        st, lo, hi = span
        ent = self._ranges.get(st._cdata)
        if ent is None:
            from torch.multiprocessing.reductions import StorageWeakRef

            ent = self._ranges[st._cdata] = (StorageWeakRef(st), {})
        ranges = ent[1]
        if replace:
            for key in [k for k in ranges if lo <= k[0] and k[1] <= hi]:
                del ranges[key]
        ranges[(lo, hi)] = ranges.get((lo, hi), frozenset()) | positions


class CollectiveRecorder:
    """What :func:`record_collectives` hands back: ``records``, one
    ``(op, per-position result shape)`` a collective call of the thread
    that opened it, and ``placement`` (a :class:`Placement`, or None)."""

    def __init__(self, positions: bool):
        self.thread = threading.get_ident()
        self.records: List[Tuple[str, str]] = []
        #: > 0 while a recorded collective runs (its own ops and the
        #: collectives it calls are not recorded again)
        self.depth = 0
        self.placement = Placement() if positions else None

    def owns(self) -> bool:
        return threading.get_ident() == self.thread

    def counts(self, start: int = 0) -> Dict[str, int]:
        """op -> calls, over ``records[start:]``."""
        out: Dict[str, int] = {}
        for op, _ in self.records[start:]:
            out[op] = out.get(op, 0) + 1
        return out

    def shapes(self, start: int = 0) -> Dict[str, List[str]]:
        """op -> result shapes in call order, over ``records[start:]``."""
        out: Dict[str, List[str]] = {}
        for op, shape in self.records[start:]:
            out.setdefault(op, []).append(shape)
        return out


#: the recorder :func:`record_collectives` has on, or None
_recorder: Optional[CollectiveRecorder] = None


@contextlib.contextmanager
def record_collectives(positions: bool = False
                       ) -> Iterator[CollectiveRecorder]:
    """Record every public collective the calling thread makes in the
    block (module docstring); with ``positions`` also keep the blocks'
    mesh positions. One recorder at a time."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("a collective recorder is already on")
    rec = CollectiveRecorder(positions)
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = None


def tag_position(t: torch.Tensor, position: int) -> torch.Tensor:
    """Mark ``t`` as mesh position ``position``'s block, where a mesh
    helper cuts it (a no-op unless a recorder keeps positions)."""
    rec = _recorder
    if rec is not None and rec.placement is not None:
        rec.placement.add(t, frozenset((position,)), replace=True)
    return t


def _note(op: str, t: torch.Tensor) -> None:
    """Record one collective from inside a recorded collective's body
    (``merge_candidates``' two all-gathers)."""
    rec = _recorder
    if rec is not None and rec.depth == 1 and rec.owns():
        rec.records.append((op, hlo_shape(t)))


def _collective(op: Optional[str]) -> Callable:
    """Decorator of a public collective: with a recorder on, the call is
    recorded once as ``op`` with its first per-position result's shape
    (``op`` None: the body records through :func:`_note`)."""

    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            rec = _recorder
            if rec is None or rec.depth or not rec.owns():
                return fn(*args, **kwargs)
            rec.depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                rec.depth -= 1
            if op is not None:
                first = out[0] if isinstance(out, (list, tuple)) else out
                rec.records.append((op, hlo_shape(first)))
            return out
        return run

    return deco


def _axes(mesh: DeviceMesh, axis: Optional[Axis]) -> Tuple[int, ...]:
    """Indices of the mesh axes ``axis`` names (every axis for None)."""
    if axis is None:
        return tuple(range(len(mesh.axis_names)))
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    for a in names:
        if a not in mesh.axis_names:
            raise ValueError(f"axis {a!r} is not one of {mesh.axis_names}")
    return tuple(mesh.axis_names.index(a) for a in names)


def axis_index(mesh: DeviceMesh, position: int,
               axis: Axis = MODEL_AXIS) -> int:
    """Where ``position`` sits along ``axis`` (several axes: their
    combined row-major index): ``lax.axis_index`` of the position's
    body."""
    c = mesh.coords(position)
    idx = 0
    for a in _axes(mesh, axis):
        idx = idx * mesh.shape[a] + c[a]
    return idx


def axis_group(mesh: DeviceMesh, position: int,
               axis: Axis = MODEL_AXIS) -> List[int]:
    """The positions a collective over ``axis`` joins ``position``
    with, in their order along the axis."""
    keep = set(range(len(mesh.axis_names))) - set(_axes(mesh, axis))
    c = mesh.coords(position)
    group = [p for p in range(mesh.size)
             if all(mesh.coords(p)[a] == c[a] for a in keep)]
    return sorted(group, key=lambda p: axis_index(mesh, p, axis))


def _check_local(shards: Sequence[torch.Tensor], mesh: DeviceMesh
                 ) -> Tuple[int, ...]:
    local = mesh.local_positions()
    if len(shards) != len(local):
        raise ValueError(f"{len(shards)} blocks for the {len(local)} "
                         f"positions this process owns")
    return local


def gather_positions(shards: Sequence[torch.Tensor], mesh: DeviceMesh,
                     op: str = "all_gather") -> List[torch.Tensor]:
    """Every position's block, in position order, given this process's
    (``shards``, one a local position). A one-process mesh hands the
    list back. Over a process mesh every process contributes its blocks
    stacked ([k, ...], the same shape on each) to one
    ``torch.distributed.all_gather``; the others' blocks arrive on this
    process's first local device (counted in ``multihost.HOST_STAGED``
    when gloo moves CUDA blocks through the host)."""
    local = _check_local(shards, mesh)
    if not mesh.spans_processes:
        return list(shards)
    import torch.distributed as dist

    from . import multihost

    multihost.fire_collective(op)
    dev = shards[0].device
    mine = torch.stack([s.to(dev) for s in shards])
    group = multihost.device_group()
    parts = [torch.empty_like(mine)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, mine, group=group)
    if dev.type == "cuda" and multihost.backend() == "gloo":
        multihost.HOST_STAGED["collectives"] += 1
        multihost.HOST_STAGED["bytes"] += sum(p.nbytes for p in parts)
    blocks: Dict[int, torch.Tensor] = {}
    for rank, part in enumerate(parts):
        for k, p in enumerate(mesh.local_positions(rank)):
            blocks[p] = part[k]
    for k, p in enumerate(local):
        blocks[p] = shards[k]  # this process's own, on their devices
    return [blocks[p] for p in range(mesh.size)]


def _group_sum(blocks: List[torch.Tensor], group: List[int],
               dev: torch.device) -> torch.Tensor:
    """The blocks of ``group`` added in the group's order on ``dev``."""
    total = blocks[group[0]].to(dev, copy=True)
    for p in group[1:]:
        total += blocks[p].to(dev)
    return total


def _collect(mesh: DeviceMesh, axis: Optional[Axis], fn) -> List:
    """``fn(group, device)`` once per (axis group, device) pair, one
    result a local position."""
    out, memo = [], {}
    for p in mesh.local_positions():
        group = axis_group(mesh, p, axis)
        dev = mesh.devices[p]
        key = (tuple(group), str(dev))
        if key not in memo:
            memo[key] = fn(group, dev, p)
        out.append(memo[key])
    return out


@_collective("all-reduce")
def all_reduce_sum(shards: Sequence[torch.Tensor], axis: Axis = MODEL_AXIS,
                   *, mesh: DeviceMesh) -> List[torch.Tensor]:
    """``lax.psum``: each position's block summed over its ``axis``
    group, in the group's order, on the position's device."""
    blocks = gather_positions(shards, mesh, "all_reduce_sum")
    return _collect(mesh, axis,
                    lambda group, dev, p: _group_sum(blocks, group, dev))


@_collective("all-reduce")
def gramian_allreduce(shards: Sequence[torch.Tensor], *,
                      mesh: DeviceMesh) -> List[torch.Tensor]:
    """``x^T x`` of a table row-sharded over every axis of ``mesh``: an
    explicit per-shard partial (``torch.matmul`` in f32, as the JAX
    package's ``dot_general`` outside any Pallas kernel), the partials
    summed in position order, one result a local position (shared by the
    positions of one device). A shard's zero padding adds nothing."""
    parts = [torch.matmul(s.float().T, s.float()) for s in shards]
    return all_reduce_sum(parts, axis=None, mesh=mesh)


@_collective("all-gather")
def all_gather(shards: Sequence[torch.Tensor], axis: Axis = MODEL_AXIS,
               *, mesh: DeviceMesh, tiled: bool = True
               ) -> List[torch.Tensor]:
    """``lax.all_gather``: each position gets its ``axis`` group's blocks
    in the group's order, concatenated along the leading dimension
    (``tiled``) or stacked."""
    blocks = gather_positions(shards, mesh, "all_gather")
    join = torch.cat if tiled else torch.stack
    return _collect(mesh, axis, lambda group, dev, p: join(
        [blocks[q].to(dev) for q in group]))


@_collective("reduce-scatter")
def reduce_scatter(shards: Sequence[torch.Tensor], axis: Axis = MODEL_AXIS,
                   *, mesh: DeviceMesh) -> List[torch.Tensor]:
    """``lax.psum_scatter(tiled=True)``: the blocks of an ``axis`` group
    summed in the group's order, and each position keeps the slice of
    the leading dimension at its index along the axis."""
    blocks = gather_positions(shards, mesh, "reduce_scatter")
    sums = _collect(mesh, axis,
                    lambda group, dev, p: _group_sum(blocks, group, dev))
    out = []
    for total, p in zip(sums, mesh.local_positions()):
        n = len(axis_group(mesh, p, axis))
        if total.shape[0] % n:
            raise ValueError(f"{total.shape[0]} rows do not scatter over "
                             f"{n} positions")
        k = total.shape[0] // n
        i = axis_index(mesh, p, axis)
        out.append(total[i * k:(i + 1) * k])
    return out


@_collective("collective-permute")
def ring_permute(shards: Sequence[torch.Tensor], axis: Axis = MODEL_AXIS,
                 shift: int = 1, *, mesh: DeviceMesh) -> List[torch.Tensor]:
    """``lax.ppermute`` around the ``axis`` ring: the block at index
    ``i`` goes to index ``i + shift`` (mod the group), so each position
    receives its ring neighbour's block. Blocks whose neighbour is in
    this process are copied; over a process mesh the others travel point
    to point, one block a message (module docstring)."""
    local = _check_local(shards, mesh)
    mine = {p: k for k, p in enumerate(local)}
    out: List[Optional[torch.Tensor]] = [None] * len(local)
    remote_src: List[Tuple[int, int]] = []   # (receiving position, source)
    for k, p in enumerate(local):
        group = axis_group(mesh, p, axis)
        src = group[(axis_index(mesh, p, axis) - shift) % len(group)]
        if src in mine:
            out[k] = shards[mine[src]].to(mesh.devices[p], copy=True)
        else:
            remote_src.append((p, src))
    sends: List[Tuple[int, int]] = []        # (receiving position, source)
    if mesh.spans_processes:
        for p in local:
            group = axis_group(mesh, p, axis)
            dst = group[(axis_index(mesh, p, axis) + shift) % len(group)]
            if dst not in mine:
                sends.append((dst, p))
    if remote_src or sends:
        _exchange_p2p(shards, mesh, mine, sends, remote_src, out)
    return out


def _exchange_p2p(shards: Sequence[torch.Tensor], mesh: DeviceMesh,
                  mine: Dict[int, int], sends: List[Tuple[int, int]],
                  recvs: List[Tuple[int, int]],
                  out: List[Optional[torch.Tensor]]) -> None:
    """One ``batch_isend_irecv`` of the ring's cross-process blocks. Each
    message is tagged with its receiving position, and both sides list
    their messages in the order of that position, so NCCL (which matches
    by order) and gloo (by tag) pair them alike."""
    import torch.distributed as dist

    from . import multihost

    multihost.fire_collective("ring_permute")
    staged = multihost.backend() == "gloo"
    group = multihost.device_group()
    ops, landed = [], []
    for dst, p in sorted(sends):
        block = shards[mine[p]].contiguous()
        if staged and block.device.type == "cuda":
            # ptpu: allow[host-sync-in-hot-path] — gloo sends CPU tensors
            # only: this copy is the transport, counted in HOST_STAGED
            block = block.cpu()
            multihost.HOST_STAGED["collectives"] += 1
            multihost.HOST_STAGED["bytes"] += block.nbytes
        ops.append(dist.P2POp(dist.isend, block, mesh.ranks[dst], group,
                              tag=dst))
    for p, src in sorted(recvs):
        like = shards[mine[p]]
        dev = mesh.devices[p]
        host = staged and dev.type == "cuda"
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if host else dev)
        ops.append(dist.P2POp(dist.irecv, buf, mesh.ranks[src], group,
                              tag=p))
        landed.append((p, buf, host))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for p, buf, host in landed:
        multihost.P2P_RECEIVED["messages"] += 1
        multihost.P2P_RECEIVED["bytes"] += buf.nbytes
        if host:
            multihost.HOST_STAGED["collectives"] += 1
            multihost.HOST_STAGED["bytes"] += buf.nbytes
            buf = buf.to(mesh.devices[p])
        out[mine[p]] = buf


Spec = Union[None, str, Sequence[str]]


def _split(x, mesh: DeviceMesh, spec: Spec, dim: int = 0
           ) -> List[torch.Tensor]:
    """This process's blocks of ``x`` under ``spec``: dimension ``dim``
    (the leading one by default) split over the spec's axes (every
    position along the other axes gets the same block), or the whole of
    ``x`` for a replicated spec (``None`` or ``()``)."""
    t = torch.as_tensor(x)
    out = []
    for p in mesh.local_positions():
        dev = mesh.devices[p]
        if not spec:
            out.append(t.to(dev))
            continue
        n = 1
        for a in _axes(mesh, spec):
            n *= mesh.shape[a]
        if t.shape[dim] % n:
            raise ValueError(f"{t.shape[dim]} entries of dimension {dim} "
                             f"do not split over {n} positions")
        k = t.shape[dim] // n
        i = axis_index(mesh, p, spec)
        out.append(tag_position(t.narrow(dim, i * k, k).to(dev), p))
    return out


def _assemble(blocks: Sequence[torch.Tensor], mesh: DeviceMesh,
              spec: Spec, dim: int = 0) -> torch.Tensor:
    """The whole value of per-position outputs under ``spec``: the first
    position's block for a replicated spec, else the blocks of the
    spec's axes along the first position's row, in order, joined along
    dimension ``dim``."""
    if not spec:
        return blocks[0]
    return _join_spec(blocks, mesh, spec, dim)


@_collective("all-gather")
def _join_spec(blocks: Sequence[torch.Tensor], mesh: DeviceMesh,
               spec: Spec, dim: int) -> torch.Tensor:
    """:func:`_assemble` of a split spec: the all-gather of its blocks."""
    every = gather_positions(list(blocks), mesh, "sharded")
    group = axis_group(mesh, 0, spec)
    dev = blocks[0].device
    return torch.cat([every[p].to(dev) for p in group], dim=dim)


def sharded(mesh: DeviceMesh, in_specs, out_specs,
            check_vma: bool = False) -> Callable:
    """Decorator, the port of ``shard_map``: the function receives, for
    each argument, the list of this process's blocks under its in-spec
    (one a local position) and returns a list of per-position blocks (or
    a tuple of such lists), joined under the out-specs. Collectives
    inside take those lists::

        @sharded(mesh, in_specs=MODEL_AXIS, out_specs=None)
        def global_norm(shards):
            return all_reduce_sum([(s ** 2).sum() for s in shards],
                                  mesh=mesh)
    """

    def deco(fn):
        def run(*args):
            specs = in_specs if isinstance(in_specs, list) \
                else [in_specs] * len(args)
            outs = fn(*[_split(a, mesh, s) for a, s in zip(args, specs)])
            if isinstance(out_specs, tuple) and isinstance(outs, tuple):
                return tuple(_assemble(o, mesh, s)
                             for o, s in zip(outs, out_specs))
            return _assemble(outs, mesh, out_specs)
        return run

    return deco


def shard_map_compat(fn: Callable, mesh: DeviceMesh, in_specs, out_specs,
                     check: bool = False) -> Callable:
    """``sharded(mesh, in_specs, out_specs)(fn)``: the JAX package's
    version shim, one function here."""
    return sharded(mesh, in_specs, out_specs)(fn)


@_collective(None)
def merge_candidates(scores: Sequence[torch.Tensor],
                     ids: Sequence[torch.Tensor], k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` best of per-shard candidate lists (``[B, k_s]`` scores
    and GLOBAL ids each, any devices) by (score descending, id
    ascending): ``(scores [B, k], ids [B, k])`` on the first list's
    device. The order is total, so the result is what one ranking of
    the whole table gives."""
    dev = scores[0].device
    s = torch.cat([t.to(dev) for t in scores], dim=1)
    i = torch.cat([t.to(dev).to(torch.int32) for t in ids], dim=1)
    # the JAX merge's two all-gathers: the candidates' scores and ids
    _note("all-gather", s)
    _note("all-gather", i)
    return merge_partial_topk(s[:, None, :], i[:, None, :], k=k)


def sharded_top_k(scores: Union[torch.Tensor, Sequence[torch.Tensor]],
                  k: int, mesh: DeviceMesh, axis: str = MODEL_AXIS
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k over a score vector split evenly over ``mesh``'s
    ``axis``: a local top-k per shard (ids offset by the shard's origin),
    then :func:`merge_candidates` of the ``k * n_shards`` candidates.
    ``scores`` is the whole ``[..., n]`` vector or its per-shard blocks.
    Returns ``(global indices, values)``, the JAX package's order."""
    n_shards = mesh.axis_size(axis)
    if isinstance(scores, torch.Tensor):
        if scores.shape[-1] % n_shards:
            raise ValueError(f"{scores.shape[-1]} scores do not split over "
                             f"{n_shards} shards of axis {axis!r}")
        blocks = list(torch.chunk(scores, n_shards, dim=-1))
    else:
        blocks = list(scores)
    lead = tuple(blocks[0].shape[:-1])
    vals, gids, base = [], [], 0
    for block in blocks:
        b2 = block.reshape(-1, block.shape[-1]).float()
        kk = min(k, b2.shape[1])
        s, pos = torch.sort(b2, dim=1, descending=True, stable=True)
        vals.append(s[:, :kk])
        gids.append(pos[:, :kk] + base)
        base += block.shape[-1]
    v, i = merge_candidates(vals, gids, k)
    return i.long().reshape(lead + (k,)), v.reshape(lead + (k,))
