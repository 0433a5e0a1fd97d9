"""Ragged rating histories packed into dense per-row layouts (the port's
copy of ``predictionio_tpu/ops/ragged.py``: pad, bucket and split
layouts).

Each row's history (the counterpart ids and ratings of one user or item)
becomes a fixed-length slice of an index matrix and a value matrix;
padding carries index 0 and value 0, and ``counts`` holds the true
lengths, so a weight mask keeps padding inert. Entries keep their input
order within a row (a stable sort by row), and a ``max_len`` cap drops
the entries past it in that order.

The arrays are element for element those of the JAX package's packers,
padding sentinels included. The bucket plan is host numpy (it needs only
the per-row counts); the sort and scatter of the triples run in torch on
the device the caller names, so training packs on the card and the
packed tensors never cross the host boundary again.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

log = logging.getLogger(__name__)

#: With no explicit cap, the dense [n_rows, max_len] matrices are bounded
#: to this many entries; beyond it the longest histories are truncated to
#: the smallest length covering 99.9% of rows.
AUTO_CAP_ENTRIES = 200_000_000


@dataclass(frozen=True)
class PaddedHistories:
    """Per-row padded histories: ``indices[i, k]`` is the k-th counterpart
    id of row i (0-padded), ``values[i, k]`` its rating (0-padded), and
    ``counts[i]`` the kept history length. Tensors share one device.
    ``n_kept`` is ``counts``' sum, kept on the host at pack time."""

    indices: torch.Tensor  # [n_rows, max_len] int32
    values: torch.Tensor   # [n_rows, max_len] float32
    counts: torch.Tensor   # [n_rows] int32
    n_kept: int

    @property
    def n_rows(self) -> int:
        return self.indices.shape[0]

    @property
    def max_len(self) -> int:
        return self.indices.shape[1]


@dataclass(frozen=True)
class HistoryBucket:
    """One length class of a :class:`BucketedHistories` layout: the rows
    whose history fits ``length`` and not ``length / 2``. ``row_ids[j]``
    is the real row of bucket row j; padding rows carry distinct
    sentinels at or past ``n_rows_padded``, so writing the solved rows
    back is a unique-index write that drops them."""

    length: int
    indices: torch.Tensor  # [n_bk_pad, L] int32
    values: torch.Tensor   # [n_bk_pad, L] float32
    counts: torch.Tensor   # [n_bk_pad] int32 (true history length)
    row_ids: torch.Tensor  # [n_bk_pad] int32

    @property
    def n_rows(self) -> int:
        return self.indices.shape[0]


@dataclass(frozen=True)
class BucketedHistories:
    """Drop-free layout for skewed histories: each row is padded to the
    next power of two of its own length (at least ``min_len``) instead of
    one global length, so padding stays under 2x and nothing is dropped.
    Rows with no history join no bucket. ``n_kept`` is the entries the
    buckets hold, counted on the host at pack time."""

    buckets: tuple          # of HistoryBucket, ascending length
    n_rows: int
    n_rows_padded: int
    n_kept: int

    @property
    def padded_entries(self) -> int:
        return sum(b.n_rows * b.length for b in self.buckets)

    @property
    def max_len(self) -> int:
        return max((b.length for b in self.buckets), default=1)


def resolve_max_len(counts: np.ndarray, n_rows: int,
                    max_len: Optional[int]) -> int:
    """Padded history length: the explicit cap, or the longest row with
    the 99.9th-percentile auto-cap (warning when entries get dropped)."""
    if max_len is not None:
        return max(int(max_len), 1)
    L = int(counts.max(initial=1))
    if n_rows * L > AUTO_CAP_ENTRIES:
        capped = int(np.quantile(counts, 0.999)) or 1
        capped = max(capped, AUTO_CAP_ENTRIES // max(n_rows, 1))
        if capped < L:
            dropped = int(np.maximum(counts - capped, 0).sum())
            log.warning(
                "pack_histories: capping history length %d -> %d (99.9th "
                "pct; dense layout would be %dx%d); dropping %d/%d "
                "entries from the heaviest rows. Set max_len to "
                "override.", L, capped, n_rows, L, dropped,
                int(counts.sum()))
            L = capped
    return max(L, 1)


def bucket_layout(counts: np.ndarray, min_len: int = 8,
                  pad_rows_to: int = 1, max_len: Optional[int] = None):
    """Host-side bucket plan: per-row bucket length (next power of two of
    the row's count, at least ``min_len``, optionally capped at
    ``max_len`` -- capped rows truncate like the pad layout), the member
    rows of each bucket, and the flat offset of every row's first slot.
    Returns ``(plan, row_base, S)`` with ``plan`` a list of
    ``(L, rows_k, n_bk_pad, offset)`` and ``S`` the total slots."""
    n_rows = len(counts)
    if max_len is not None:
        counts = np.minimum(counts, max_len)
    lengths = np.maximum(min_len, 1 << np.int64(
        np.ceil(np.log2(np.maximum(counts, 1)))))
    lengths[counts == 0] = 0  # empty rows join no bucket
    plan = []
    row_base = np.zeros(n_rows, dtype=np.int64)
    off = 0
    for L in np.unique(lengths):
        if L == 0:
            continue
        rows_k = np.flatnonzero(lengths == L)
        n_bk = len(rows_k)
        n_bk_pad = max(-(-n_bk // pad_rows_to) * pad_rows_to, pad_rows_to)
        row_base[rows_k] = off + np.arange(n_bk, dtype=np.int64) * int(L)
        plan.append((int(L), rows_k, n_bk_pad, off))
        off += n_bk_pad * int(L)
    return plan, row_base, off


def _host_tensor(arr, dtype) -> torch.Tensor:
    """A CPU tensor of ``arr`` as ``dtype`` (copied when numpy hands out
    a read-only view, which torch cannot wrap)."""
    # ptpu: allow[host-sync-in-hot-path] — host numpy in, a CPU tensor
    # out: no device value reaches np.asarray here. The caller's
    # .to(device) then copies host to device from pageable memory.
    a = np.asarray(arr, dtype=dtype)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _pack_flat(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               row_base: np.ndarray, row_cap: np.ndarray, n_rows: int,
               S: int, dev: torch.device):
    """Stable sort of the triples by row, then a scatter of each entry to
    ``row_base[row] + pos_in_row`` in flat ``[S]`` index and value
    buffers on ``dev``; entries at or past a row's ``row_cap`` drop."""
    r = _host_tensor(rows, np.int64).to(dev)
    order = torch.argsort(r, stable=True)
    rs = r[order]
    cs = _host_tensor(cols, np.int32).to(dev)[order]
    vs = _host_tensor(vals, np.float32).to(dev)[order]
    counts = torch.bincount(rs, minlength=n_rows)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(rs.shape[0], device=dev) - starts[rs]
    base = _host_tensor(row_base, np.int64).to(dev)
    cap = _host_tensor(row_cap, np.int64).to(dev)
    # slot S is a trash slot for dropped entries, cut off below
    dest = torch.where(pos < cap[rs], base[rs] + pos, S)
    idx = torch.zeros(S + 1, dtype=torch.int32, device=dev)
    val = torch.zeros(S + 1, dtype=torch.float32, device=dev)
    idx[dest] = cs
    val[dest] = vs
    return idx[:S], val[:S]


def pack_histories_device(rows: np.ndarray, cols: np.ndarray,
                          vals: np.ndarray, n_rows: int, max_len: int,
                          pad_rows_to: int = 1,
                          device: DeviceLike = None) -> PaddedHistories:
    """The pad layout: ``[n_pad, L]`` matrices with ``n_pad`` the row
    count rounded up to ``pad_rows_to``; entries past ``max_len`` in a
    row are dropped in input order. Packed on ``device`` (the card by
    default)."""
    dev = resolve_device(device)
    L = max(int(max_len), 1)
    n_pad = ((n_rows + pad_rows_to - 1) // pad_rows_to) * pad_rows_to
    rows = np.asarray(rows)  # ptpu: allow[host-sync-in-hot-path] — host COO
    base = np.arange(n_rows, dtype=np.int64) * L
    idx, val = _pack_flat(rows, cols, vals, base, np.full(n_rows, L),
                          n_rows, n_pad * L, dev)
    cnt = np.zeros(n_pad, np.int32)
    cnt[:n_rows] = np.minimum(np.bincount(rows, minlength=n_rows), L)
    return PaddedHistories(indices=idx.reshape(n_pad, L),
                           values=val.reshape(n_pad, L),
                           counts=torch.from_numpy(cnt).to(dev),
                           n_kept=int(cnt.sum()))


def pack_histories(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                   n_rows: int, max_len: Optional[int] = None,
                   pad_rows_to: int = 1) -> PaddedHistories:
    """The JAX package's host packer: the pad layout packed on the CPU,
    with ``max_len`` None resolved as :func:`resolve_max_len` does (the
    longest row, auto-capped). Its arrays are element for element those
    of :func:`pack_histories_device` at the resolved length."""
    rows = np.asarray(rows)  # ptpu: allow[host-sync-in-hot-path] — host COO
    counts = np.bincount(rows, minlength=n_rows)
    L = resolve_max_len(counts, n_rows, max_len)
    return pack_histories_device(rows, cols, vals, n_rows, L,
                                 pad_rows_to=pad_rows_to, device="cpu")


def transpose_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Swap the roles of rows and cols (users and items)."""
    return cols, rows, vals


def pack_histories_bucketed_device(rows: np.ndarray, cols: np.ndarray,
                                   vals: np.ndarray, n_rows: int,
                                   pad_rows_to: int = 1, min_len: int = 8,
                                   max_len: Optional[int] = None,
                                   counts: Optional[np.ndarray] = None,
                                   device: DeviceLike = None
                                   ) -> BucketedHistories:
    """The bucketed layout (:class:`BucketedHistories`): the host plans
    the buckets from the per-row counts, one sort and scatter on
    ``device`` fills a flat buffer, and each bucket is a view of it.
    ``max_len`` caps each row's history (truncating in input order);
    without it the layout is drop-free."""
    dev = resolve_device(device)
    rows = np.asarray(rows)  # ptpu: allow[host-sync-in-hot-path] — host COO
    if counts is None:
        counts = np.bincount(rows, minlength=n_rows)
    if max_len is not None:
        counts = np.minimum(counts, int(max_len))
    plan, row_base, S = bucket_layout(counts, min_len, pad_rows_to)
    n_rows_pad = max(-(-n_rows // pad_rows_to) * pad_rows_to, pad_rows_to)
    if S == 0:
        return BucketedHistories(buckets=(), n_rows=n_rows,
                                 n_rows_padded=n_rows_pad, n_kept=0)
    flat_idx, flat_val = _pack_flat(rows, cols, vals, row_base, counts,
                                    n_rows, S, dev)
    buckets = []
    for L, rows_k, n_bk_pad, off in plan:
        n_bk = len(rows_k)
        # each padding row gets a DISTINCT out-of-range sentinel, so the
        # writeback's indices stay unique even though those rows drop
        row_ids = (n_rows_pad
                   + np.arange(n_bk_pad, dtype=np.int64) - n_bk
                   ).astype(np.int32)
        row_ids[:n_bk] = rows_k
        cnt = np.zeros(n_bk_pad, dtype=np.int32)
        cnt[:n_bk] = counts[rows_k]
        buckets.append(HistoryBucket(
            length=L,
            indices=flat_idx[off:off + n_bk_pad * L].view(n_bk_pad, L),
            values=flat_val[off:off + n_bk_pad * L].view(n_bk_pad, L),
            counts=torch.from_numpy(cnt).to(dev),
            row_ids=torch.from_numpy(row_ids).to(dev)))
    return BucketedHistories(buckets=tuple(buckets), n_rows=n_rows,
                             n_rows_padded=n_rows_pad,
                             n_kept=int(counts.sum()))


@dataclass(frozen=True)
class SplitHistories:
    """Drop-free row-split layout: every real row becomes ``ceil(count /
    L)`` *virtual rows* of up to L entries, in order, so no entry is ever
    dropped whatever the skew. Training computes each virtual row's
    normal-equation partials and sums them onto the owning real row
    before one solve a real row.

    ``indices``/``values`` are ``[n_virtual_pad, L]``; ``counts`` holds
    the entries of each virtual row; ``row_ids[v]`` is the real row that
    owns virtual row v (``n_rows`` on padding rows). A real row's virtual
    rows are contiguous and real rows ascend, so every segment of
    ``row_ids`` is one real row. ``real_counts`` are the real rows' true
    totals (the regularization's scale). ``n_kept`` is the entries the
    virtual rows hold, counted on the host at pack time."""

    indices: torch.Tensor      # [n_virtual_pad, L] int32
    values: torch.Tensor       # [n_virtual_pad, L] float32
    counts: torch.Tensor       # [n_virtual_pad] int32 (a virtual row's)
    row_ids: torch.Tensor      # [n_virtual_pad] int32 -> real row or n_rows
    real_counts: torch.Tensor  # [n_rows_pad] int32
    n_rows: int                # real rows (unpadded)
    n_kept: int

    @property
    def n_virtual(self) -> int:
        return self.indices.shape[0]

    @property
    def n_rows_padded(self) -> int:
        return self.real_counts.shape[0]

    @property
    def max_len(self) -> int:
        return self.indices.shape[1]


def split_layout(counts: np.ndarray, max_len: int,
                 pad_rows_to: int = 1):
    """Host-side split bookkeeping: per-real-row virtual-row counts, the
    total virtual rows and the padded virtual-row count."""
    groups = -(-counts // max_len)  # ceil; 0-count rows get 0 virtual rows
    n_virtual = int(groups.sum())
    n_vpad = max(((n_virtual + pad_rows_to - 1) // pad_rows_to)
                 * pad_rows_to, pad_rows_to)
    return groups.astype(np.int64), n_virtual, n_vpad


def _split_meta(counts: np.ndarray, groups: np.ndarray, n_rows: int,
                L: int, n_virtual: int, n_vpad: int, pad_rows_to: int):
    """``(row_ids, vcounts, real_counts)`` of a split layout, host numpy."""
    gstarts = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(groups, out=gstarts[1:])
    row_ids = np.full(n_vpad, n_rows, dtype=np.int32)
    row_ids[:n_virtual] = np.repeat(np.arange(n_rows, dtype=np.int32),
                                    groups)
    vcounts = np.zeros(n_vpad, dtype=np.int32)
    # entries in virtual row v of row r: min(L, count_r - k * L)
    k_within = np.arange(n_virtual) - gstarts[row_ids[:n_virtual]]
    vcounts[:n_virtual] = np.minimum(
        counts[row_ids[:n_virtual]] - k_within * L, L).astype(np.int32)
    n_rows_pad = max(((n_rows + pad_rows_to - 1) // pad_rows_to)
                     * pad_rows_to, pad_rows_to)
    real_counts = np.zeros(n_rows_pad, dtype=np.int32)
    real_counts[:n_rows] = counts
    return gstarts, row_ids, vcounts, real_counts


def pack_histories_split(rows: np.ndarray, cols: np.ndarray,
                         vals: np.ndarray, n_rows: int, max_len: int,
                         pad_rows_to: int = 1) -> SplitHistories:
    """Host-numpy split packing (:class:`SplitHistories`), CPU tensors."""
    L = max(int(max_len), 1)
    # ptpu: allow[host-sync-in-hot-path] — the host COO columns
    rows, cols, vals = np.asarray(rows), np.asarray(cols), np.asarray(vals)
    order = np.argsort(rows, kind="stable")
    rs, cs, vs = rows[order], cols[order], vals[order]
    counts = np.bincount(rs, minlength=n_rows).astype(np.int64)
    groups, n_virtual, n_vpad = split_layout(counts, L, pad_rows_to)
    gstarts, row_ids, vcounts, real_counts = _split_meta(
        counts, groups, n_rows, L, n_virtual, n_vpad, pad_rows_to)
    starts = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(len(rs)) - starts[rs]
    vrow = gstarts[rs] + pos // L
    vpos = pos % L
    indices = np.zeros((n_vpad, L), dtype=np.int32)
    values = np.zeros((n_vpad, L), dtype=np.float32)
    indices[vrow, vpos] = cs
    values[vrow, vpos] = vs
    return SplitHistories(
        indices=torch.from_numpy(indices), values=torch.from_numpy(values),
        counts=torch.from_numpy(vcounts), row_ids=torch.from_numpy(row_ids),
        real_counts=torch.from_numpy(real_counts), n_rows=n_rows,
        n_kept=int(counts.sum()))


def pack_histories_split_device(rows: np.ndarray, cols: np.ndarray,
                                vals: np.ndarray, n_rows: int,
                                max_len: int, pad_rows_to: int = 1,
                                counts: Optional[np.ndarray] = None,
                                device: DeviceLike = None
                                ) -> SplitHistories:
    """The split layout packed on ``device`` (the card by default): the
    host plans it from the per-row counts, and one sort and scatter on
    the device fill it. A real row's virtual rows are contiguous, so its
    entries land at ``gstarts[row] * L + position``: the bucket packer's
    flat scatter with that base."""
    dev = resolve_device(device)
    L = max(int(max_len), 1)
    rows = np.asarray(rows)  # ptpu: allow[host-sync-in-hot-path] — host COO
    if counts is None:
        counts = np.bincount(rows, minlength=n_rows)
    # ptpu: allow[host-sync-in-hot-path] — host counts (bincount's, or
    # the caller's histogram)
    counts = np.asarray(counts, dtype=np.int64)
    groups, n_virtual, n_vpad = split_layout(counts, L, pad_rows_to)
    gstarts, row_ids, vcounts, real_counts = _split_meta(
        counts, groups, n_rows, L, n_virtual, n_vpad, pad_rows_to)
    idx, val = _pack_flat(rows, cols, vals, gstarts[:n_rows] * L, counts,
                          n_rows, n_vpad * L, dev)
    return SplitHistories(
        indices=idx.reshape(n_vpad, L), values=val.reshape(n_vpad, L),
        counts=torch.from_numpy(vcounts).to(dev),
        row_ids=torch.from_numpy(row_ids).to(dev),
        real_counts=torch.from_numpy(real_counts).to(dev), n_rows=n_rows,
        n_kept=int(counts.sum()))
