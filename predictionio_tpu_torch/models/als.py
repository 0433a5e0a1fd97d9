"""ALS on the card: the training and serving halves of
``predictionio_tpu/models/als.py``.

Training (:func:`train_als`) alternates half-steps: each packs one side's
rating histories (``ops/ragged.py``, pad or bucket layout), builds every
row's normal equations against the fixed other side in
:func:`_lhs_fn` -- the hand-written fused gather + Gramian kernel
(``ops/fused_gram.py``) for ``gram_mode`` "fused" (and "auto" up to the
kernel's rank limit), the plain gather and einsum (``ops/gram.py``)
otherwise -- adds ALS-WR regularization ``reg * max(n, 1) * I`` (and for
implicit feedback the fixed side's Gramian), and solves them all with
the hand-written batched Cholesky kernel (``ops/solve.py``). CPU tensors
take each kernel's plain version; nothing falls back on the card.

A trained model is two factor tables plus the id maps. Serving ranks all
items for a user by ``user_row . item_row`` and returns the top k, ties
to the lower item id. Every batch goes to ``ops/fused_topk.py`` (the
hand-written kernel for CUDA tensors, its plain version for CPU tensors);
``k`` past the kernel's limit goes to :func:`_serve_topk`, the plain
matmul and sort. A model placed on the card is served by the card: there
is no size-based host path.

Serving tables may be row-quantized at deploy time (int8 with per-row
absmax scales, or bf16) behind an NDCG@10 parity probe against the f32
ranking (:func:`quantize_serving_model`); products always accumulate f32.

Streaming fold-in (:func:`fold_in_rows` and the functional row updates
after it) re-solves touched rows through the same :func:`_update_block`
as training, so it launches ``fused_gram`` and ``chol_solve`` too.

The hot-entity tier's pinned table (:func:`pin_user_rows`) is a row
gather on the card; :func:`recommend_pinned` ranks a pinned user through
the same top-k dispatch with that table as the user table.

Training packs one of three layouts: pad, bucket (the drop-free default
past the pad layout's size) or split (``history_mode="split"``: long
rows become several virtual rows whose ``fused_gram`` partials are summed
onto their real row in a fixed order before one ``chol_solve`` a real
row). With ``checkpoint_dir`` it saves the factors every
``checkpoint_every`` iterations (``workflow/checkpoint.py``) and resumes
a restarted run from the newest restorable step.

Training over a mesh (``train_als(mesh=)``, section "training over a
mesh"): every position of a ``(data, model)`` mesh updates its block of
each side's rows from the whole fixed side, all-gathered once a
half-step; each block is cut where the single card cuts its row blocks
and launched as that block (``fused_gram``'s ``plan_rows``), so explicit
factors are the single card's bit for bit. Across processes
(``parallel/multihost.py``) each process packs only its own rows
(:func:`pack_ratings_multihost`, from a COO or a sharded source).

Mesh-wide serving (:func:`shard_model`, :func:`replicate_model`): a
sharded model's tables are split by rows over a serving mesh
(:class:`RowShardedTable`, ``parallel/mesh.py``). A sharded batch
gathers its user rows across the shards, in the table's own dtype with
their scales, and launches ``fused_topk`` once per shard with ``base``
at that shard's first global id; the per-shard candidates merge in the
kernel's own total order (``parallel/collectives.py``), so a sharded
answer is the single-table answer, ids exactly. A replicated lane's
model is one full copy on the lane's device; :func:`pin_user_rows_lanes`
pins the hot rows once per lane device. The fold-in against a sharded
table gathers the fixed rows it names across the shards and solves them
exactly as the single-table fold-in does; the solved rows scatter back
into their owning shards.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import json
import logging
import math
import threading
import warnings
import weakref
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..obs import numerics as _numerics
from ..ops.fused_gram import FUSED_GRAM_MAX_RANK, fused_gram
from ..ops.fused_topk import TOPK_MAX_K, fused_topk, fused_topk_reference
from ..ops.gram import gram_dispatch
from ..ops.ragged import (
    AUTO_CAP_ENTRIES,
    BucketedHistories,
    PaddedHistories,
    SplitHistories,
    pack_histories_bucketed_device,
    pack_histories_device,
    pack_histories_split_device,
    resolve_max_len,
)
from ..ops.solve import gramian, solve_spd_batch
from ..parallel.collectives import all_gather, merge_candidates, tag_position
from ..parallel.mesh import DeviceMesh
from ..utils.device import DeviceLike, resolve_device
from ..utils.memo import ComputeOnce

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class ALSParams:
    """Hyperparameters, name-compatible with the recommendation template's
    engine.json (rank, numIterations, lambda, seed) plus the implicit-ALS
    knobs. Same fields and validation as the JAX package's ``ALSParams``;
    serving reads none of the training knobs, but a model carries them."""

    rank: int = 10
    num_iterations: int = 10
    #: regularization — "lambda" in engine.json; the wire alias keeps
    #: those variant files working verbatim
    reg: float = field(default=0.01,
                       metadata={"aliases": ("lambda", "lambda_")})
    alpha: float = 1.0
    implicit_prefs: bool = False
    seed: int = 3
    max_history: Optional[int] = None
    scale_reg_by_count: bool = True
    block_rows: Optional[int] = None
    matmul_dtype: str = "float32"
    gather_dtype: str = "float32"
    gram_mode: str = "auto"
    history_mode: str = "auto"

    def __post_init__(self):
        if self.matmul_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"matmul_dtype must be 'float32' or 'bfloat16', got "
                f"{self.matmul_dtype!r}")
        if self.gather_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"gather_dtype must be 'float32' or 'bfloat16', got "
                f"{self.gather_dtype!r}")
        if self.history_mode not in ("auto", "pad", "split", "bucket"):
            raise ValueError(
                f"history_mode must be 'auto', 'pad', 'split' or "
                f"'bucket', got {self.history_mode!r}")
        if self.gram_mode not in ("auto", "einsum", "pair", "fused"):
            raise ValueError(
                f"gram_mode must be 'auto', 'einsum', 'pair' or "
                f"'fused', got {self.gram_mode!r}")


#: the ServerConfig.serving_quant vocabulary
SERVING_QUANT_MODES = ("off", "bf16", "int8")

#: NDCG@10-vs-f32 floor the deploy-time parity probe enforces before a
#: quantized table may serve
SERVING_QUANT_NDCG_FLOOR = 0.97


@dataclass
class QuantizedFactors:
    """A row-quantized serving table: ``data`` [n, r] int8 with per-row
    f32 absmax ``scale`` [n, 1], or bf16 with no scale. Serving upcasts
    after the load (inside the kernel), never as an f32 copy of the
    table."""

    data: torch.Tensor
    scale: Optional[torch.Tensor] = None
    quant: str = "int8"

    def to(self, device: torch.device) -> "QuantizedFactors":
        return QuantizedFactors(
            self.data.to(device),
            None if self.scale is None else self.scale.to(device),
            self.quant)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def nbytes(self) -> int:
        """The table's bytes on its device: data plus scale."""
        nb = int(self.data.nbytes)
        if self.scale is not None:
            nb += int(self.scale.nbytes)
        return nb


Table = Union[torch.Tensor, QuantizedFactors]


@dataclass
class ALSModel:
    """Factor tables (torch tensors or :class:`QuantizedFactors`, rows
    possibly padded past n_users/n_items) plus the id maps back to
    entity-id strings."""

    user_factors: Table
    item_factors: Table
    n_users: int
    n_items: int
    user_ids: Optional[object] = None
    item_ids: Optional[object] = None
    params: ALSParams = field(default_factory=ALSParams)
    #: the serving mesh when the tables are row-sharded
    #: (:func:`shard_model`); None otherwise. Set at deploy only: a
    #: persisted model never carries a mesh
    mesh: Optional[DeviceMesh] = None


@dataclass
class RowShardedTable:
    """A factor table split by rows over a serving mesh
    (:func:`shard_model`): ``shards[s]`` holds the global rows ``[s *
    n_local, (s + 1) * n_local)`` on ``mesh.devices[s]``, each shard a
    tensor of its own or a :class:`QuantizedFactors` with its own int8 or
    bf16 data and f32 scales. The rows past the model's real count are
    zero padding to a shard multiple."""

    shards: Tuple[Table, ...]
    mesh: DeviceMesh

    @property
    def n_local(self) -> int:
        return int(_table_leaves(self.shards[0])[0].shape[0])

    @property
    def shape(self) -> Tuple[int, int]:
        data = _table_leaves(self.shards[0])[0]
        return (int(data.shape[0]) * len(self.shards), int(data.shape[1]))

    @property
    def device(self) -> torch.device:
        """The first shard's device: where gathers and merges land."""
        return _table_leaves(self.shards[0])[0].device


AnyTable = Union[torch.Tensor, QuantizedFactors, RowShardedTable]


def _table_leaves(t: Table) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(data, scale-or-None) of a factor table, quantized or plain."""
    if isinstance(t, QuantizedFactors):
        return t.data, t.scale
    return t, None


def _table_device(t: AnyTable) -> torch.device:
    """Where a table lives (a row-sharded one: its first shard)."""
    if isinstance(t, RowShardedTable):
        return t.device
    return _table_leaves(t)[0].device


def table_quant(t: AnyTable) -> str:
    """The quant dtype of a factor table ("off" for plain f32)."""
    if isinstance(t, RowShardedTable):
        t = t.shards[0]
    return t.quant if isinstance(t, QuantizedFactors) else "off"


def serving_quant_of(model) -> str:
    """The serving-quant realization of a bound model."""
    return table_quant(getattr(model, "item_factors", model))


def _quantize_rows(rows: np.ndarray, quant: str
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Host-side row quantization: per-row absmax scale -> int8 in
    [-127, 127] (symmetric, so dequant is one multiply), or a bf16 cast
    (round to nearest even, through torch). The int8 arithmetic is the
    JAX package's, in numpy, so the tables are bitwise equal."""
    rows = np.asarray(rows, dtype=np.float32)
    if quant == "bf16":
        return torch.from_numpy(np.ascontiguousarray(rows)).to(
            torch.bfloat16), None
    if quant != "int8":
        raise ValueError(f"quant must be 'bf16' or 'int8', got {quant!r}")
    amax = np.max(np.abs(rows), axis=-1, keepdims=True) \
        if rows.size else np.zeros((rows.shape[0], 1), np.float32)
    scale = np.maximum(amax, 1e-12).astype(np.float32) / 127.0
    data = np.clip(np.rint(rows / scale), -127, 127).astype(np.int8)
    return torch.from_numpy(data), torch.from_numpy(scale)


def table_host_f32(t) -> np.ndarray:
    """Host f32 copy of a factor table (plain, quantized or row-sharded,
    card or host resident) — the parity-probe view."""
    if isinstance(t, RowShardedTable):
        return np.concatenate([table_host_f32(s) for s in t.shards])
    if isinstance(t, QuantizedFactors):
        data = t.data.float().cpu().numpy()
        if t.scale is not None:
            data = data * t.scale.cpu().numpy()
        return data
    if isinstance(t, np.ndarray):
        return np.asarray(t, dtype=np.float32)
    return t.float().cpu().numpy()


def _binary_ndcg(ranked, relevant, k: int) -> float:
    """Binary NDCG@k of one ranked id list against a relevant-id set."""
    dcg = sum(1.0 / np.log2(i + 2.0)
              for i, x in enumerate(ranked[:k]) if x in relevant)
    ideal = sum(1.0 / np.log2(i + 2.0)
                for i in range(min(k, len(relevant))))
    return float(dcg / ideal) if ideal else 0.0


def _host_topk(user_vecs: np.ndarray, item_factors: np.ndarray,
               k: int, n_items: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host numpy top-k: descending score, ties to the LOWEST item index.
    Used by the quantization parity probe only; serving goes to the card."""
    scores = np.asarray(user_vecs) @ np.asarray(item_factors)[:n_items].T
    k = min(k, n_items)
    ids = np.empty((scores.shape[0], k), dtype=np.int64)
    out = np.empty((scores.shape[0], k), dtype=scores.dtype)
    idx_key = np.arange(n_items)
    for b in range(scores.shape[0]):
        order = np.lexsort((idx_key, -scores[b]))[:k]
        ids[b] = order
        out[b] = scores[b, order]
    return ids, out


def serving_quant_ndcg(U: np.ndarray, V: np.ndarray, qU, qV,
                       n_items: int, k: int = 10, sample: int = 32,
                       seed: int = 0) -> float:
    """Mean NDCG@k of the QUANTIZED ranking against the f32 ranking's
    top-k over a user sample (the same sample as the JAX package draws)."""
    n = min(sample, U.shape[0])
    if n == 0 or n_items == 0:
        return 1.0
    users = np.random.default_rng(seed).choice(U.shape[0], size=n,
                                               replace=False)
    kk = min(k, n_items)
    ids_f, _ = _host_topk(U[users], V, kk, n_items)
    ids_q, _ = _host_topk(table_host_f32(qU)[users],
                          table_host_f32(qV), kk, n_items)
    return float(np.mean([
        _binary_ndcg(list(a), set(b.tolist()), kk)
        for a, b in zip(ids_q, ids_f)]))


def quantize_serving_model(model: ALSModel, quant: str, *,
                           parity_floor: float = SERVING_QUANT_NDCG_FLOOR,
                           parity_sample: int = 32, parity_k: int = 10,
                           seed: int = 0) -> ALSModel:
    """A model whose serving tables are row-quantized to ``quant``
    ("int8" | "bf16"; "off" returns the input), on the host, before the
    model is placed on the card.

    Auto-off: a parity probe ranks ``parity_sample`` users through both
    tables and requires NDCG@``parity_k`` >= ``parity_floor`` against the
    f32 ranking; a model that cannot take the quantization keeps its f32
    tables (logged)."""
    if quant in (None, "", "off"):
        return model
    if quant not in ("bf16", "int8"):
        raise ValueError(
            f"serving quant must be one of {SERVING_QUANT_MODES}, "
            f"got {quant!r}")
    if isinstance(model.user_factors, QuantizedFactors):
        return model
    U = table_host_f32(model.user_factors)
    V = table_host_f32(model.item_factors)
    qU = QuantizedFactors(*_quantize_rows(U, quant), quant=quant)
    qV = QuantizedFactors(*_quantize_rows(V, quant), quant=quant)
    if parity_floor and parity_sample > 0:
        ndcg = serving_quant_ndcg(U, V, qU, qV, model.n_items,
                                  k=parity_k, sample=parity_sample,
                                  seed=seed)
        if ndcg < parity_floor:
            log.warning(
                "serving_quant=%s parity probe failed (NDCG@%d %.4f "
                "< %.2f vs f32); keeping full-precision serving "
                "tables (auto-off)", quant, parity_k, ndcg, parity_floor)
            return model
    return dataclasses.replace(model, user_factors=qU, item_factors=qV,
                               mesh=None)


def place_model(model: ALSModel, device: DeviceLike = None) -> ALSModel:
    """The model with both tables on ``device`` (the card by default),
    moved once at deploy so no query re-transfers them. A sharded model
    is returned as it is: its shards are placed already."""
    if model.mesh is not None:
        return model
    dev = resolve_device(device)
    return dataclasses.replace(model,
                               user_factors=model.user_factors.to(dev),
                               item_factors=model.item_factors.to(dev))


def ensure_device_resident(model: ALSModel, max_batch: int = 1,
                           device: DeviceLike = None) -> ALSModel:
    """The JAX package's deploy-time placement: there, a catalog small
    enough for its host route stays in host memory. The card has no host
    route (``ROADMAP.md``, "Decided not to port"), so every model moves
    to ``device`` once, as :func:`place_model` does; ``max_batch`` (the
    largest batch a surface coalesces, which sized the JAX package's
    host budget) is accepted for its signature."""
    return place_model(model, device)


# -- mesh-wide serving placement -------------------------------------------

def _pad_rows(t: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad the row axis to a shard multiple (even shards)."""
    n = int(t.shape[0])
    n_pad = -(-n // multiple) * multiple
    if n_pad == n:
        return t
    return torch.cat([t, t.new_zeros((n_pad - n,) + tuple(t.shape[1:]))])


def unshard_table(t: AnyTable) -> Table:
    """One table of a row-sharded one, on its first shard's device (its
    padding rows kept); any other table as it is."""
    if not isinstance(t, RowShardedTable):
        return t
    dev = t.device
    datas = [_table_leaves(s)[0].to(dev) for s in t.shards]
    if not isinstance(t.shards[0], QuantizedFactors):
        return torch.cat(datas)
    scales = None if t.shards[0].scale is None \
        else torch.cat([s.scale.to(dev) for s in t.shards])
    return QuantizedFactors(torch.cat(datas), scales, t.shards[0].quant)


def _shard_table(t: AnyTable, mesh: DeviceMesh) -> RowShardedTable:
    """``t`` split by rows over every device of ``mesh``, zero-padded to a
    shard multiple; a quantized table splits leaf by leaf, so each shard
    holds its rows' data and scales. Every shard is a copy of its own."""
    t = unshard_table(t)
    data, scale = _table_leaves(t)
    n_dev = mesh.size
    data = _pad_rows(data, n_dev)
    scale = None if scale is None else _pad_rows(scale, n_dev)
    n_local = int(data.shape[0]) // n_dev
    shards = []
    for s, dev in enumerate(mesh.devices):
        rows = slice(s * n_local, (s + 1) * n_local)
        d = tag_position(data[rows].to(dev, copy=True), s)
        if isinstance(t, QuantizedFactors):
            shards.append(QuantizedFactors(
                d, None if scale is None
                else tag_position(scale[rows].to(dev, copy=True), s),
                t.quant))
        else:
            shards.append(d)
    return RowShardedTable(tuple(shards), mesh)


def shard_model(model: ALSModel, mesh: DeviceMesh) -> ALSModel:
    """SHARDED serving placement: both factor tables split by rows over
    every device of the ``(batch, model)`` serving mesh
    (:class:`RowShardedTable`), zero-padded to a shard multiple while
    ``n_users`` / ``n_items`` keep the real counts, so padding is never
    served."""
    return dataclasses.replace(
        model,
        user_factors=_shard_table(model.user_factors, mesh),
        item_factors=_shard_table(model.item_factors, mesh),
        mesh=mesh)


def replicate_model(model: ALSModel, device: DeviceLike) -> ALSModel:
    """REPLICATED serving placement: one full copy of the factor tables
    on ``device``, a replicated lane's own model. On a device the tables
    already live on (several lanes on one card) the copy is the tables
    themselves: a lane only reads them."""
    dev = torch.device(device)
    return dataclasses.replace(
        model,
        user_factors=unshard_table(model.user_factors).to(dev),
        item_factors=unshard_table(model.item_factors).to(dev),
        mesh=None)


# -- serving ----------------------------------------------------------------

def _serve_topk(user_factors: Table, item_factors: Table,
                idx: torch.Tensor, *, k: int, n_items: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain serving program for k past the kernel's limit: user-row
    gather, upcast and scales, ``[B, r] x [I, r]^T`` product, pad mask,
    and a stable descending sort (ties to the lower id)."""
    ud, us = _table_leaves(user_factors)
    vd, vs = _table_leaves(item_factors)
    return fused_topk_reference(ud, idx, vd, us, vs, k=k, n_items=n_items)


def _compiled_k(k: int, n_items: int) -> int:
    """k rounded up to a power of two (clamped to the catalog), as the JAX
    package serves it, so a query's num and blacklist map onto a few
    kernel shapes; callers slice the first ``k``."""
    k = min(k, n_items)
    p = 1
    while p < k:
        p <<= 1
    return min(p, n_items)


def _device_topk(user_table: Table, item_table: Table, idx: np.ndarray,
                 k_dev: int, n_items: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batched top-k dispatch: the fused kernel for ``k_dev`` up to
    ``TOPK_MAX_K``, else :func:`_serve_topk`. Both share tie semantics
    (descending score, lowest id first). Returns ``(scores, ids)``."""
    ud, us = _table_leaves(user_table)
    vd, vs = _table_leaves(item_table)
    idx_t = torch.from_numpy(np.asarray(idx, dtype=np.int32))
    if ud.is_cuda:
        # through pinned memory: a copy from pageable memory may wait for
        # the kernels already queued on the stream
        idx_t = idx_t.pin_memory().to(ud.device, non_blocking=True)
    if 1 <= k_dev <= TOPK_MAX_K:
        return fused_topk(ud, idx_t, vd, us, vs, k=k_dev, n_items=n_items)
    return _serve_topk(user_table, item_table, idx_t, k=k_dev,
                       n_items=n_items)


#: serializes SHARDED serving dispatches process-wide, as the JAX
#: package does: there a sharded batch is one mesh program whose
#: candidate all-gather deadlocks when two threads interleave their
#: per-device launches. Here a sharded batch is its user-row gather, one
#: ``fused_topk`` launch per shard and the merge; under the lock they
#: enqueue as one unit, so a fold-in's scatter into the shards never lands
#: between one batch's shard launches. Readbacks run outside it
_mesh_dispatch_lock = threading.Lock()


def _index_tensor(rows: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host row ids as an int64 tensor on ``dev``; to the card through
    pinned memory, so the copy never waits for the work already queued."""
    t = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int64))
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    return t


def _user_vecs(user_factors: AnyTable, user_indices: np.ndarray,
               dev: torch.device
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The ``[B, r]`` rows of ``user_indices`` in the table's OWN dtype,
    and their ``[B, 1]`` f32 scales (None for a table without), on
    ``dev``: what each shard's ``fused_topk`` launch takes as its user
    table, with ``idx = arange(B)``. A row-sharded table is read shard by
    shard (each row from its owner), so the table never exists whole on
    one device."""
    rows = np.asarray(user_indices, dtype=np.int64)
    if not isinstance(user_factors, RowShardedTable):
        data, scale = _table_leaves(user_factors)
        idx = _index_tensor(rows, data.device)
        return (data.index_select(0, idx).to(dev),
                None if scale is None else scale.index_select(0, idx).to(dev))
    n_local = user_factors.n_local
    d0, s0 = _table_leaves(user_factors.shards[0])
    out_d = torch.empty((len(rows), d0.shape[1]), dtype=d0.dtype, device=dev)
    out_s = None if s0 is None else torch.empty(
        (len(rows), 1), dtype=torch.float32, device=dev)
    owner = rows // n_local
    for s in np.unique(owner):
        pos = np.flatnonzero(owner == s)
        sd, ss = _table_leaves(user_factors.shards[int(s)])
        local = _index_tensor(rows[pos] - int(s) * n_local, sd.device)
        where = _index_tensor(pos, dev)
        out_d[where] = sd.index_select(0, local).to(dev)
        if out_s is not None:
            out_s[where] = ss.index_select(0, local).to(dev)
    return out_d, out_s


def _rank_sharded(vecs: torch.Tensor, vscale: Optional[torch.Tensor],
                  item_factors: RowShardedTable, k_dev: int, n_items: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank ``[B, r]`` query rows (and their scales) against a row-sharded
    item table: one ``fused_topk`` launch per shard, with ``idx =
    arange(B)``, ``base`` the shard's first global id, ``k_local =
    min(k_dev, n_local)`` and the real ``n_items`` (so padding is never
    served); then :func:`~..parallel.collectives.merge_candidates` of the
    ``k_local * n_shards`` candidates, by (score descending, id
    ascending): the kernel's own order, so the answer is the whole
    table's. ``k_local`` past the kernel's limit takes the plain version
    per shard. Returns ``(scores, ids)`` ``[B, k_dev]`` on the first
    shard's device. Callers hold ``_mesh_dispatch_lock``."""
    n_local = item_factors.n_local
    k_local = min(k_dev, n_local)
    B = int(vecs.shape[0])
    parts_s, parts_i = [], []
    arange = {}
    for s, shard in enumerate(item_factors.shards):
        vd, vs = _table_leaves(shard)
        dev = vd.device
        if dev not in arange:
            arange[dev] = torch.arange(B, dtype=torch.int32, device=dev)
        ud = vecs.to(dev)
        us = None if vscale is None else vscale.to(dev)
        if 1 <= k_local <= TOPK_MAX_K:
            # ptpu: allow[blocking-under-lock] — the shard launches and
            # their merge are one sharded dispatch (the JAX package's
            # mesh program, whose launch is the lock's whole purpose);
            # nothing here waits for the card
            sc, gid = fused_topk(ud, arange[dev], vd, us, vs, s * n_local,
                                 k=k_local, n_items=n_items)
        else:
            sc, gid = fused_topk_reference(ud, arange[dev], vd, us, vs,
                                           s * n_local, k=k_local,
                                           n_items=n_items)
        parts_s.append(sc)
        parts_i.append(gid)
    return merge_candidates(parts_s, parts_i, k_dev)


def _sharded_topk(user_table: AnyTable, item_table: RowShardedTable,
                  rows: np.ndarray, k_dev: int, n_items: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sharded batched top-k: the user-row gather and
    :func:`_rank_sharded`, under ``_mesh_dispatch_lock``."""
    with _mesh_dispatch_lock:
        vecs, vscale = _user_vecs(user_table, rows, item_table.device)
        return _rank_sharded(vecs, vscale, item_table, k_dev, n_items)


def recommend_batch_sharded(user_factors, item_factors,
                            user_indices: np.ndarray, k: int,
                            mesh: DeviceMesh, n_items: int
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Serving top-k over a mesh: item rows split over every device of
    ``mesh`` (a :class:`RowShardedTable`, or a whole table split here),
    the user rows gathered across their shards, one ``fused_topk`` launch
    a shard and the merge. The same answer as the single-table path, ids
    exactly (both rank by score descending, then id ascending). Host
    tables may come as numpy. Returns host ``(ids, scores)`` ``[B, k]``."""
    def as_table(t):
        return torch.from_numpy(np.ascontiguousarray(t)) \
            if isinstance(t, np.ndarray) else t

    if not isinstance(item_factors, RowShardedTable):
        item_factors = as_table(item_factors)
        n_pad = int(_table_leaves(item_factors)[0].shape[0])
        if n_pad % mesh.size:
            raise ValueError(
                f"item rows {n_pad} not divisible by mesh size "
                f"{mesh.size}; pad factors to a device multiple "
                f"(shard_model does)")
        item_factors = _shard_table(item_factors, mesh)
    user_factors = as_table(user_factors)
    ids, scores = _dispatch_topk_rows(user_factors, item_factors, n_items,
                                      np.asarray(user_indices), k)()
    return ids, scores


def recommend_products(model: ALSModel, user_index: int, k: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k (item_index, score) for one user. Asking for more than the
    catalog returns the whole catalog ranked, never padded rows."""
    ids, scores = recommend_batch(model, np.asarray([user_index]), k)
    return ids[0], scores[0]


#: top-k rows per dispatch: bounds the plain path's [chunk, n_items]
#: score matrix for large eval sweeps
_TOPK_CHUNK = 2048


def _dispatch_topk_rows(user_table: AnyTable, item_table: AnyTable,
                        n_items: int, rows: np.ndarray, k: int
                        ) -> Callable[[], Tuple[np.ndarray, np.ndarray]]:
    """Launch ONE top-k dispatch of the user-table ``rows`` and return a
    resolver that waits for it and hands back host ``([B, k] ids,
    scores)``. A row-sharded item table takes :func:`_sharded_topk` (one
    launch a shard and the merge). On the card both device-to-host copies
    are queued right behind the launch, into pinned host memory, and a
    CUDA event after them: the resolver waits on that event alone, so
    launches queued after this one (the next batches) never hold its
    readback."""
    kk = min(k, n_items)
    k_dev = _compiled_k(k, n_items)
    if isinstance(item_table, RowShardedTable):
        scores, ids = _sharded_topk(user_table, item_table, rows, k_dev,
                                    n_items)
    else:
        scores, ids = _device_topk(user_table, item_table, rows, k_dev,
                                   n_items)
    if not scores.is_cuda:
        ids_h, scores_h, done = ids, scores, None
    else:
        ids_h = torch.empty(ids.shape, dtype=ids.dtype, pin_memory=True)
        scores_h = torch.empty(scores.shape, dtype=scores.dtype,
                               pin_memory=True)
        ids_h.copy_(ids, non_blocking=True)
        scores_h.copy_(scores, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(scores.device))

    def resolve() -> Tuple[np.ndarray, np.ndarray]:
        if done is not None:
            done.synchronize()
        s_h = scores_h.numpy()
        if _numerics.active():
            # debug_numerics: a NaN probe of the served scores' host copy
            # (the JAX package's "serve_topk" seam); nan_only because
            # padded slots legitimately score -inf. Here, never in the
            # dispatch half, which must not wait on the card
            _numerics.check_array("serve_topk", s_h, nan_only=True)
        return (ids_h.numpy()[:, :kk].astype(np.int64),
                s_h[:, :kk].copy())

    return resolve


def recommend_batch_async(model: ALSModel, user_indices: np.ndarray,
                          k: int) -> Callable[[], Tuple[np.ndarray,
                                                        np.ndarray]]:
    """Dispatch/readback split of :func:`recommend_batch`: launches the
    work and returns a no-arg resolver that blocks until the results are
    on the host. Batches past ``_TOPK_CHUNK`` launch every chunk up front
    and the resolver drains them in order."""
    user_indices = np.asarray(user_indices)
    B = len(user_indices)
    kk = min(k, model.n_items)
    if B == 0:
        empty = (np.empty((0, kk), np.int64), np.empty((0, kk), np.float32))
        return lambda: empty
    resolvers = [
        _dispatch_topk_rows(model.user_factors, model.item_factors,
                            model.n_items, user_indices[s:s + _TOPK_CHUNK], k)
        for s in range(0, B, _TOPK_CHUNK)]
    if len(resolvers) == 1:
        return resolvers[0]

    def resolve() -> Tuple[np.ndarray, np.ndarray]:
        parts = [r() for r in resolvers]
        return (np.concatenate([p[0] for p in parts], axis=0),
                np.concatenate([p[1] for p in parts], axis=0))

    return resolve


def recommend_batch(model: ALSModel, user_indices: np.ndarray, k: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k for many users: :func:`recommend_batch_async` and an
    immediate readback, so the two paths cannot diverge."""
    return recommend_batch_async(model, user_indices, k)()


def table_rows_f32(t: AnyTable, rows) -> np.ndarray:
    """Host f32 copies of a table's ``rows``, dequantized (what the table
    serves); a row-sharded table reads each row from its owner shard."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    if isinstance(t, RowShardedTable):
        data, scale = _user_vecs(t, rows, t.device)
    else:
        data, scale = _table_leaves(t)
        idx = torch.from_numpy(rows).to(data.device)
        data = data.index_select(0, idx)
        scale = None if scale is None else scale.index_select(0, idx)
    out = data.float()
    if scale is not None:
        out = out * scale.reshape(-1, 1)
    return out.cpu().numpy()


def predict_rating(model: ALSModel, user_index: int, item_index: int
                   ) -> float:
    u = table_rows_f32(model.user_factors, [user_index])[0]
    v = table_rows_f32(model.item_factors, [item_index])[0]
    return float(u @ v)


# -- the hot-entity tier's pinned rows ----------------------------------------

def _wait_copies(tables) -> None:
    """On the card, return only once the copies that made ``tables`` have
    run (an event after them on each device, waited for), so a serving
    thread handed a table never reads it half written."""
    for dev in {_table_leaves(t)[0].device for t in tables}:
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
            done.synchronize()


def _nbytes(t: Table) -> int:
    data, scale = _table_leaves(t)
    n = data.numel() * data.element_size()
    if scale is not None:
        n += scale.numel() * scale.element_size()
    return n


def pin_user_rows(model: ALSModel, user_indices, capacity: int
                  ) -> Tuple[Optional[Table], int]:
    """Gather the given users' factor rows into ONE ``[capacity, rank]``
    table on the model's own device (the hot-entity tier's pinned table):
    ``index_select`` on the device's tables, for a quantized table on its
    data and its scales, so the rows are the source rows bit for bit and
    no table crosses to the host. A sharded model's rows are gathered
    from their owner shards onto the first shard's device (the JAX
    package's mesh-replicated pin). The slots past ``len(user_indices)``
    hold row 0 (the JAX package's padding). On the card the function
    returns only once the copy has run.

    Returns ``(pinned_table, nbytes)``; ``(None, 0)`` for no users."""
    if not len(user_indices):
        return None, 0
    cap = max(int(capacity), 1)
    idx = np.zeros(cap, dtype=np.int64)
    n = min(len(user_indices), cap)
    idx[:n] = np.asarray(list(user_indices)[:n], dtype=np.int64)
    uf = model.user_factors
    if isinstance(uf, RowShardedTable):
        with _mesh_dispatch_lock:
            data, scale = _user_vecs(uf, idx, uf.device)
    else:
        data, scale = _user_vecs(uf, idx, _table_device(uf))
    quant = table_quant(uf)
    # ptpu: allow[quantize-without-parity-gate] — a residency move: the
    # bound table's own rows under its own quant (table_quant), gated
    # where that table was quantized; nothing is quantized here
    pinned = QuantizedFactors(data, scale, quant) if quant != "off" \
        else data
    _wait_copies([pinned])
    return pinned, _nbytes(pinned)


def pin_user_rows_lanes(model: ALSModel, user_indices, capacity: int,
                        devices) -> Tuple[Optional[tuple], int]:
    """The replicated lanes' hot tier: the SAME pinned ``[capacity,
    rank]`` table (:func:`pin_user_rows`) once per lane device, so
    whichever lane serves a hot query reads its own device's copy. Lanes
    that share a device share its copy. Returns ``(tables_per_device,
    total_nbytes)`` or ``(None, 0)``."""
    if not len(user_indices) or not len(devices):
        return None, 0
    base, nbytes = pin_user_rows(model, user_indices, capacity)
    tables = tuple(base.to(torch.device(d)) for d in devices)
    _wait_copies(tables)
    return tables, nbytes * len(tables)


def recommend_pinned(model: ALSModel, pinned, slot: int, k: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k (item_index, score) for one PINNED hot user: the row is
    gathered from the small pinned table (:func:`pin_user_rows`) instead
    of the full ``[U, rank]`` table and scored against the model's item
    table. On the card that is one ``fused_topk`` launch with the pinned
    table as its user table and ``idx = [slot]`` (one a shard for a
    sharded model); k past the kernel's limit takes :func:`_serve_topk`,
    as every serve does. ``pinned`` may be the per-device tuple of
    :func:`pin_user_rows_lanes`: the copy on the device of ``model``'s
    item table serves, so a lane's hot serve stays on its device."""
    if isinstance(pinned, tuple):
        dev = _table_device(model.item_factors)
        pinned = next((t for t in pinned if _table_device(t) == dev),
                      pinned[0])
    ids, scores = _dispatch_topk_rows(
        pinned, model.item_factors, model.n_items,
        np.asarray([slot], dtype=np.int64), k)()
    return ids[0], scores[0]


# -- training ---------------------------------------------------------------

@dataclass(frozen=True)
class RatingsCOO:
    """Integer-indexed rating triples (host numpy)."""

    users: np.ndarray    # int32 [nnz]
    items: np.ndarray    # int32 [nnz]
    ratings: np.ndarray  # float32 [nnz]
    n_users: int
    n_items: int


def _resolves_fused(gram: str, rank: int) -> bool:
    """Whether ``gram`` lands on the fused kernel: "fused" explicitly
    (raising past the kernel's rank limit), or "auto" within it -- "auto"
    never resolves to a kernel that cannot take the shape."""
    if gram == "fused":
        if rank > FUSED_GRAM_MAX_RANK:
            raise ValueError(
                f"gram_mode='fused' takes rank <= {FUSED_GRAM_MAX_RANK}, "
                f"got {rank}; use 'auto' or 'einsum'")
        return True
    return gram == "auto" and rank <= FUSED_GRAM_MAX_RANK


def resolved_gram_mode(params: ALSParams) -> str:
    """The concrete gram realization ``params`` trains with."""
    if params.gram_mode != "auto":
        return params.gram_mode
    return "fused" if _resolves_fused("auto", params.rank) else "einsum"


def _fused_lhs(table: torch.Tensor, indices: torch.Tensor,
               wa: torch.Tensor, wb: torch.Tensor,
               plan_rows: Optional[int] = None):
    """The fused realization of :func:`_lhs_fn`: gather and Gramian in
    one kernel launch; the ``[..., L, r]`` gather never exists."""
    r = table.shape[-1]
    L = indices.shape[-1]
    lead = tuple(indices.shape[:-1])
    A, b = fused_gram(table, indices.reshape(-1, L).contiguous(),
                      wa.reshape(-1, L).contiguous(),
                      wb.reshape(-1, L).contiguous(), plan_rows=plan_rows)
    return A.reshape(lead + (r, r)), b.reshape(lead + (r,))


def _lhs_fn(table: torch.Tensor, indices: torch.Tensor, wa: torch.Tensor,
            wb: torch.Tensor, *, gram: str, bf16: bool,
            plan_rows: Optional[int] = None):
    """Per-row normal equations, the one place the factor gather exists:
    ``A = sum_l wa * f f^T`` and ``b = sum_l wb * f`` over
    ``f = table[indices]``. ``table`` is the f32 factors or their bf16
    shadow; weights arrive pre-masked, so padding contributes zero.
    "fused" (and "auto" within the kernel's rank) goes to the fused
    kernel; every other mode gathers and takes ``ops/gram.py``."""
    if _resolves_fused(gram, table.shape[-1]):
        return _fused_lhs(table, indices, wa, wb, plan_rows)
    F = table[indices.long()]
    A = gram_dispatch(F, wa, mode=gram, bf16=bf16)
    # a bf16 shadow is upcast first: the right-hand side sums in f32 too
    b = torch.einsum("...lr,...l->...r", F.float(), wb.float())
    return A, b


def _shadow_lhs_fn(table_f32: torch.Tensor, indices: torch.Tensor,
                   wa: torch.Tensor, wb: torch.Tensor, *, gram: str,
                   bf16: bool):
    """:func:`_lhs_fn` over the bf16 shadow of an f32 table (the
    ``gather_dtype="bfloat16"`` wire), for one-off callers; the
    half-steps cast one shadow per half-step and share it."""
    return _lhs_fn(table_f32.bfloat16(), indices, wa, wb, gram=gram,
                   bf16=bf16)


def _weights(values: torch.Tensor, counts: torch.Tensor, alpha: float,
             implicit: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked Gramian and right-hand-side weights of a ``[B, L]`` block.
    Implicit (Hu-Koren-Volinsky): ``wa = c - 1 = alpha * r`` and
    ``wb = c = 1 + alpha * r`` on observed slots; explicit: ``wa = 1``,
    ``wb = r``. Padding gets 0."""
    L = values.shape[-1]
    valid = (torch.arange(L, device=values.device)[None, :]
             < counts[:, None]).float()
    if implicit:
        wa = alpha * values * valid
        wb = (wa + 1.0) * valid
    else:
        wa = valid
        wb = values * valid
    return wa, wb


def _update_block(fixed: torch.Tensor, G: Optional[torch.Tensor],
                  indices: torch.Tensor, values: torch.Tensor,
                  counts: torch.Tensor, reg: float, alpha: float,
                  implicit: bool, scale_reg: bool, bf16: bool = False,
                  gram: str = "auto", plan_rows: Optional[int] = None
                  ) -> torch.Tensor:
    """New factors ``[B, r]`` for one block of rows, holding ``fixed``
    constant: ``G`` is the fixed side's Gramian (implicit only),
    ``indices``/``values`` ``[B, L]``, ``counts`` ``[B]``. The
    regularization (and ``G``) go onto the fresh ``A`` in place: it is
    this block's own buffer, and a copy would double its memory.
    ``plan_rows`` plans the ``fused_gram`` launch as one of that many
    rows (a shard of a mesh's block planned as the whole block)."""
    wa, wb = _weights(values, counts, alpha, implicit)
    A, b = _lhs_fn(fixed, indices, wa, wb, gram=gram, bf16=bf16,
                   plan_rows=plan_rows)
    if implicit:
        A += G
    reg_n = reg * torch.clamp(counts.float(), min=1.0) if scale_reg \
        else torch.full(counts.shape, reg, dtype=torch.float32,
                        device=counts.device)
    A.diagonal(dim1=-2, dim2=-1).add_(reg_n[..., None])
    return solve_spd_batch(A, b)


def _auto_block_rows(n_per: int, L: int, rank: int) -> int:
    """Rows per update block, targeting ~1 GB for the ``[B, L, r]`` f32
    gather of the einsum path (the JAX package's budget, kept so both
    packages cut the same blocks)."""
    budget = 1024 * 1024 * 1024
    b = max(64, budget // max(1, L * rank * 4))
    return min(n_per, b)


def training_blocks(h, rank: int, block_rows: Optional[int] = None):
    """``(indices, values, counts, rows)`` of every row block one
    half-step over ``h`` hands to :func:`_update_block`, in order -- the
    shapes the training path gives the kernels. ``rows`` is where the
    block's new factors go: a slice of the pad layout's rows, or the
    bucket rows' ids (padding rows carry sentinels past the table)."""
    if isinstance(h, BucketedHistories):
        for bk in h.buckets:
            block = block_rows or _auto_block_rows(bk.n_rows, bk.length,
                                                   rank)
            for s in range(0, bk.n_rows, block):
                e = min(s + block, bk.n_rows)
                yield (bk.indices[s:e], bk.values[s:e], bk.counts[s:e],
                       bk.row_ids[s:e])
        return
    block = block_rows or _auto_block_rows(h.n_rows, h.max_len, rank)
    for s in range(0, h.n_rows, block):
        e = min(s + block, h.n_rows)
        yield h.indices[s:e], h.values[s:e], h.counts[s:e], slice(s, e)


def _fixed_side_gramian(fixed: torch.Tensor,
                        n_fixed: Optional[int]) -> torch.Tensor:
    """The implicit half-step's Gramian of the fixed table over its first
    ``n_fixed`` rows (all of them for None). Its padding rows are zero,
    so cutting them changes no value, only the product's shape: cut to
    the real rows, the single device and every mesh (whose tables are
    padded to the mesh's size) run the same product on the same rows,
    bit for bit."""
    return gramian(fixed if n_fixed is None else fixed[:n_fixed])


def _update_side(fixed: torch.Tensor, h, params: ALSParams,
                 n_fixed: Optional[int] = None) -> torch.Tensor:
    """One half-iteration over either layout: the JAX package's
    ``_pad_half_impl``, ``_bucket_half_impl`` and ``_update_side*`` with
    no mesh. The fixed side's Gramian (implicit; over its ``n_fixed``
    real rows, :func:`_fixed_side_gramian`) and one bf16 shadow
    (``gather_dtype="bfloat16"``) are made once, then every row block
    goes through :func:`_update_block`. Bucket rows are written back by
    row id: each real row sits in one bucket, so the writes are unique,
    and padding rows' sentinels land in one trash row past the table,
    cut off at the end. Rows with no history keep factor 0."""
    r = fixed.shape[-1]
    G = _fixed_side_gramian(fixed, n_fixed) if params.implicit_prefs \
        else None
    gsrc = fixed.bfloat16() if params.gather_dtype == "bfloat16" else fixed
    bucketed = isinstance(h, BucketedHistories)
    n = h.n_rows_padded if bucketed else h.n_rows
    out = torch.zeros((n + bucketed, r), dtype=torch.float32,
                      device=fixed.device)
    for idx, val, cnt, rows in training_blocks(h, r, params.block_rows):
        new = _update_block(
            gsrc, G, idx, val, cnt, params.reg, params.alpha,
            params.implicit_prefs, params.scale_reg_by_count,
            bf16=params.matmul_dtype == "bfloat16", gram=params.gram_mode)
        if bucketed:
            out.index_copy_(0, torch.clamp(rows.long(), max=n), new)
        else:
            out[rows] = new
    return out[:n]


# -- the split layout ----------------------------------------------------------

def _partials_block(fixed: torch.Tensor, indices: torch.Tensor,
                    values: torch.Tensor, counts: torch.Tensor,
                    alpha: float, implicit: bool, bf16: bool, gram: str
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-VIRTUAL-row partials ``sum w f f^T`` and ``sum w f`` of one
    block of a :class:`SplitHistories`: one :func:`_lhs_fn` call, so one
    ``fused_gram`` launch on the card. Padding virtual rows have count 0
    and give exactly zero."""
    wa, wb = _weights(values, counts, alpha, implicit)
    return _lhs_fn(fixed, indices, wa, wb, gram=gram, bf16=bf16)


def _segment_sum(parts: torch.Tensor, owners: np.ndarray
                 ) -> Tuple[np.ndarray, torch.Tensor]:
    """Sum consecutive rows of ``parts`` that share an owner (``owners``,
    host, non-decreasing): ``(unique owners, sums)``. Deterministic by
    construction: no atomics, one fixed reduction a segment length class.
    A one-row segment is its row; longer ones are gathered into
    ``[n, m, ...]`` by power-of-two length class (padding at most 2x,
    pointing at a zero row) and summed over ``m``."""
    n = len(owners)
    starts = np.flatnonzero(np.r_[True, owners[1:] != owners[:-1]])
    lens = np.diff(np.r_[starts, n])
    out = parts.new_empty((len(starts),) + tuple(parts.shape[1:]))
    dev = parts.device
    single = np.flatnonzero(lens == 1)
    if len(single):
        out[torch.from_numpy(single).to(dev)] = \
            parts[torch.from_numpy(starts[single]).to(dev)]
    multi = np.flatnonzero(lens > 1)
    if len(multi):
        padded = torch.cat([parts, parts.new_zeros((1,) + parts.shape[1:])])
        cls = np.ceil(np.log2(lens[multi])).astype(np.int64)
        for c in np.unique(cls):
            segs = multi[cls == c]
            m = 1 << int(c)
            pos = starts[segs, None] + np.arange(m)[None, :]
            pos = np.where(np.arange(m)[None, :] < lens[segs, None], pos, n)
            gathered = padded[torch.from_numpy(pos.reshape(-1)).to(dev)]
            out[torch.from_numpy(segs).to(dev)] = gathered.reshape(
                (len(segs), m) + tuple(parts.shape[1:])).sum(dim=1)
    return owners[starts], out


def _split_blocks(h: SplitHistories, rank: int,
                  block_rows: Optional[int] = None):
    """The virtual-row slices one split half-step hands to
    :func:`_partials_block`, in order (the pad layout's block budget)."""
    block = block_rows or _auto_block_rows(h.n_virtual, h.max_len, rank)
    for s in range(0, h.n_virtual, block):
        yield slice(s, min(s + block, h.n_virtual))


def _solve_accumulated(A_acc: torch.Tensor, b_acc: torch.Tensor,
                       G: Optional[torch.Tensor], real_counts: torch.Tensor,
                       reg: float, scale_reg: bool) -> torch.Tensor:
    """Finish a split half-step: the implicit baseline Gramian ``G`` once
    a real row, after accumulation; ALS-WR regularization from the TRUE
    row totals; one batched SPD solve (``chol_solve`` on the card). Rows
    with no ratings keep b = 0 and solve to exactly 0, as the pad
    layout's padding does. ``A_acc`` is updated in place."""
    if G is not None:
        A_acc += G
    reg_n = reg * torch.clamp(real_counts.float(), min=1.0) if scale_reg \
        else torch.full(real_counts.shape, reg, dtype=torch.float32,
                        device=real_counts.device)
    A_acc.diagonal(dim1=-2, dim2=-1).add_(reg_n[:, None])
    return solve_spd_batch(A_acc, b_acc)


def _update_side_split(fixed: torch.Tensor, h: SplitHistories,
                       params: ALSParams,
                       n_fixed: Optional[int] = None) -> torch.Tensor:
    """One half-iteration over the split layout: each virtual-row block's
    partials (one ``fused_gram`` launch) summed onto the owning real rows
    in ``[n_pad, r, r]`` / ``[n_pad, r]`` accumulators, in a fixed order
    (:func:`_segment_sum` within a block, blocks in turn), then one solve
    of every real row. Padding virtual rows (owner ``n_rows``) are cut
    off before the sum."""
    r = fixed.shape[-1]
    G = _fixed_side_gramian(fixed, n_fixed) if params.implicit_prefs \
        else None
    gsrc = fixed.bfloat16() if params.gather_dtype == "bfloat16" else fixed
    n_pad = h.n_rows_padded
    A_acc = torch.zeros((n_pad, r, r), dtype=torch.float32,
                        device=fixed.device)
    b_acc = torch.zeros((n_pad, r), dtype=torch.float32, device=fixed.device)
    owners_all = h.row_ids.cpu().numpy()
    for sl in _split_blocks(h, r, params.block_rows):
        A_v, b_v = _partials_block(
            gsrc, h.indices[sl], h.values[sl], h.counts[sl], params.alpha,
            params.implicit_prefs, params.matmul_dtype == "bfloat16",
            params.gram_mode)
        owners = owners_all[sl]
        live = int(np.searchsorted(owners, h.n_rows))  # padding is last
        if live:
            rows, A_s = _segment_sum(A_v[:live], owners[:live])
            _, b_s = _segment_sum(b_v[:live], owners[:live])
            dst = torch.from_numpy(rows.astype(np.int64)).to(fixed.device)
            A_acc[dst] += A_s
            b_acc[dst] += b_s
    return _solve_accumulated(A_acc, b_acc, G, h.real_counts, params.reg,
                              params.scale_reg_by_count)


def auto_split_len(counts: np.ndarray) -> int:
    """The split layout's padded length: the power of two L in [32, 8192]
    minimizing the padded entries ``sum ceil(c / L) * L`` (ties to the
    larger L: fewer virtual rows to sum)."""
    best_L, best_total = 32, None
    c = counts[counts > 0]
    if c.size == 0:
        return 32
    for p in range(5, 14):  # 32 .. 8192
        L = 1 << p
        total = int((-(-c // L) * L).sum())
        if best_total is None or total <= best_total:
            best_L, best_total = L, total
    return best_L


def _auto_layout(counts: np.ndarray, n_rows: int, nnz: int) -> str:
    """"auto"'s layout for a side with these row counts: pad when the
    padded matrix fits ``AUTO_CAP_ENTRIES`` and holds at most 4x the
    entries (or 1M slots), else the drop-free bucketed layout. One rule
    for one process and for several, so both pack a side alike (the JAX
    package's multi-process packing leaves out the waste test)."""
    slots = n_rows * int(counts.max(initial=1))
    return "pad" if slots <= min(AUTO_CAP_ENTRIES,
                                 max(4 * nnz, 1_000_000)) else "bucket"


def _pack(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
          n_rows: int, params: ALSParams, device: DeviceLike,
          pad_rows_to: int = 1):
    """History packing for one side (``history_mode``): "pad" keeps
    round-1 semantics (entries past the length drop), "bucket" and
    "split" are drop-free, "auto" pads when that is dense enough and
    drops nothing (or when ``max_history`` explicitly caps), buckets
    otherwise."""
    max_history = params.max_history
    mode = params.history_mode
    counts = None
    if mode == "split":
        warnings.warn(
            "history_mode='split' sums each real row's virtual-row "
            "partials before its solve; 'bucket' is the drop-free layout "
            "of choice, 'split' is kept for comparison runs.",
            UserWarning, stacklevel=3)
        counts = np.bincount(rows, minlength=n_rows)
        L = int(max_history) if max_history is not None \
            else auto_split_len(counts)
        return pack_histories_split_device(rows, cols, vals, n_rows,
                                           max(L, 1), counts=counts,
                                           pad_rows_to=pad_rows_to,
                                           device=device)
    if mode == "auto":
        if max_history is not None:
            mode = "pad"
        else:
            counts = np.bincount(rows, minlength=n_rows)
            mode = _auto_layout(counts, n_rows, len(rows))
    if mode == "bucket":
        return pack_histories_bucketed_device(
            rows, cols, vals, n_rows, pad_rows_to=pad_rows_to,
            max_len=None if max_history is None else int(max_history),
            counts=counts, device=device)
    if max_history is not None:
        L = int(max_history)
    else:
        if counts is None:
            counts = np.bincount(rows, minlength=n_rows)
        L = resolve_max_len(counts, n_rows, None)
    return pack_histories_device(rows, cols, vals, n_rows, max(L, 1),
                                 pad_rows_to=pad_rows_to, device=device)


@dataclass
class PackedRatings:
    """Packed histories of both sides, on the training device, plus the
    real problem dims. Iterates as ``(user_h, item_h)``. Packed for a
    mesh (``mesh`` set), each side's rows are padded to a multiple of
    the mesh's size, and :meth:`mesh_side` cuts it into the per-position
    blocks the mesh trains (a process mesh's packing makes only this
    process's blocks: ``user_h``/``item_h`` are then those
    :class:`MeshSide`\\ s)."""

    user_h: object
    item_h: object
    n_users: int
    n_items: int
    mesh: Optional[DeviceMesh] = None
    _sides: dict = field(default_factory=dict, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def __iter__(self):
        return iter((self.user_h, self.item_h))

    def __getitem__(self, i: int):
        return (self.user_h, self.item_h)[i]

    def mesh_side(self, side: str, params: "ALSParams") -> "MeshSide":
        """One side's per-position blocks over :attr:`mesh`, cut once
        (and kept) for the given rank and ``block_rows``."""
        key = (side, params.rank, params.block_rows)
        with self._lock:
            out = self._sides.get(key)
            if out is None:
                h = self.user_h if side == "user" else self.item_h
                n = self.n_users if side == "user" else self.n_items
                out = _mesh_side_of(h, n, self.mesh, params)
                self._sides[key] = out
                _tag_side(out, self.mesh)
        return out


def _tag_side(side: "MeshSide", mesh: DeviceMesh) -> None:
    """Each local position's pieces (and split counts) marked as its
    blocks, for the collective census (``parallel/collectives.py``)."""
    for k, p in enumerate(mesh.local_positions()):
        for pc in side.pieces[k]:
            for t in (pc.indices, pc.values, pc.counts):
                tag_position(t, p)
        if side.real_counts:
            tag_position(side.real_counts[k], p)


def pack_ratings(ratings: RatingsCOO, params: ALSParams,
                 device: DeviceLike = None, *,
                 mesh: Optional[DeviceMesh] = None) -> PackedRatings:
    """Pack both sides' histories on ``device`` (the card by default)
    for :func:`train_als`; sweeps pack once and pass ``packed=``. With a
    ``mesh`` the rows are padded to its size and packed on its first
    device; a process mesh packs through :func:`pack_ratings_multihost`
    (each process only its own rows). A sharded source packs from its
    whole COO."""
    if mesh is not None and mesh.spans_processes:
        return pack_ratings_multihost(ratings, params, mesh)
    if hasattr(ratings, "to_coo"):
        ratings = ratings.to_coo()
    dev = resolve_device(device) if mesh is None else mesh.devices[0]
    n_dev = 1 if mesh is None else mesh.size
    users = np.asarray(ratings.users)
    items = np.asarray(ratings.items)
    vals = np.asarray(ratings.ratings)
    return PackedRatings(
        user_h=_pack(users, items, vals, ratings.n_users, params, dev,
                     n_dev),
        item_h=_pack(items, users, vals, ratings.n_items, params, dev,
                     n_dev),
        n_users=ratings.n_users, n_items=ratings.n_items, mesh=mesh)


#: id(ratings) -> (weakref to the ratings, its ComputeOnce over packing
#: keys)
_pack_cache: dict = {}
_pack_cache_lock = threading.Lock()


def pack_ratings_cached(ratings: RatingsCOO, params: ALSParams,
                        device: DeviceLike = None, *,
                        mesh: Optional[DeviceMesh] = None
                        ) -> PackedRatings:
    """Memoizing :func:`pack_ratings`, keyed by the ratings object and
    the knobs the packing reads (``history_mode``, ``max_history``, the
    device or mesh). Compute-once across threads: the workers of a
    parallel eval grid walk that miss together wait for one packing (a
    failed one is retried). Entries die with the ratings object."""
    dev = resolve_device(device) if mesh is None else mesh.devices[0]
    with _pack_cache_lock:
        ent = _pack_cache.get(id(ratings))
        if ent is None or ent[0]() is not ratings:
            rid = id(ratings)
            ent = _pack_cache[rid] = (
                weakref.ref(ratings, lambda _, i=rid: _pack_cache.pop(i, None)),
                ComputeOnce(retry_on_failure=True))
    if mesh is None:
        key = (params.history_mode, params.max_history, str(dev))
        return ent[1].get(key, lambda: pack_ratings(ratings, params, dev))
    key = (params.history_mode, params.max_history,
           tuple(str(d) for d in mesh.devices), mesh.ranks)
    return ent[1].get(key, lambda: pack_ratings(ratings, params, mesh=mesh))


# -- training over a mesh ------------------------------------------------------
#
# Each position of the mesh updates a block of rows of the side being
# solved: the pad layout's rows [s * n_per, (s + 1) * n_per), of every
# bucket of the bucketed layout the s-th of its even cuts, and of the split
# layout a run of the single card's whole blocks of virtual rows (their
# partials summed onto the real rows as the single card sums them, then
# one solve a position: ``_mesh_side_split``). A position's
# rows are cut where the single card cuts its row blocks, and each piece
# launches ``fused_gram`` planned as that whole block (``plan_rows``), so
# every row's normal equations are summed as the single card sums them;
# ``chol_solve`` solves each system alone whatever the launch. The fixed
# side enters whole on every device: the updated blocks are all-gathered
# once a half-step. The implicit Gramian is taken on each device over the
# whole fixed side's real rows, the single card's product (where the JAX
# package sums per-shard partials), so implicit feedback too gives the
# single card's factors bit for bit.


@dataclass(frozen=True)
class _Piece:
    """One ``fused_gram`` + ``chol_solve`` launch of a position: its
    rows' histories, where its solved rows go in the position's output
    block, and the row count its launch is planned for."""

    indices: torch.Tensor
    values: torch.Tensor
    counts: torch.Tensor
    offset: int
    plan_rows: int
    #: the split layout's: each virtual row's real row (host,
    #: non-decreasing); None for pad and bucket
    owners: Optional[np.ndarray] = None


@dataclass(frozen=True)
class MeshSide:
    """One side's training blocks over a mesh. ``pieces[k]`` are local
    position k's launches in order; every position's output block has
    ``block_rows_out`` rows, and ``dst[k]`` (on position k's device) maps
    the all-gathered output blocks, in position order, onto the
    factor table's rows (padding to the trash row ``n_rows_padded``);
    the pad layout needs no map (its blocks are the table in order).
    The split layout (one process, so local position k is position k)
    solves real rows: position k's are ``[row_cuts[k], row_cuts[k +
    1])``, and ``real_counts[k]`` holds their true totals (one solve a
    position)."""

    kind: str
    n_rows: int
    n_rows_padded: int
    block_rows_out: int
    pieces: Tuple[Tuple[_Piece, ...], ...]
    dst: Tuple[Optional[torch.Tensor], ...]
    real_counts: Tuple[torch.Tensor, ...] = ()
    row_cuts: Tuple[int, ...] = ()

    @property
    def launches(self) -> int:
        """``fused_gram`` launches of a half-step on this process (and
        ``chol_solve``'s, but for the split layout: :attr:`solves`)."""
        return sum(len(p) for p in self.pieces)

    @property
    def solves(self) -> int:
        """``chol_solve`` launches of a half-step on this process: one a
        piece, or for the split layout one a position that holds rows."""
        if self.kind == "split":
            return sum(int(c.shape[0]) > 0 for c in self.real_counts)
        return self.launches


def _cut_position(idx, val, cnt, start: int, n_live: int, block: int,
                  offset: int) -> List[_Piece]:
    """The pieces of one position's run of a segment (a pad layout or a
    bucket): rows ``[start, start + len)`` of the segment, cut where the
    single card's blocks of ``block`` rows end, each planned as its
    block (the last block holds ``n_live`` rows' remainder). Runs of
    padding past ``n_live`` launch nothing (their rows stay 0)."""
    m = int(idx.shape[0])
    out, s = [], 0
    while s < m and start + s < n_live:
        j = (start + s) // block
        e = min(m, (j + 1) * block - start)
        out.append(_Piece(idx[s:e], val[s:e], cnt[s:e], offset + s,
                          min(block, n_live - j * block)))
        s = e
    return out


def _mesh_dst(side_rows: List[torch.Tensor], mesh: DeviceMesh,
              n_rows_padded: int) -> Tuple[torch.Tensor, ...]:
    """The gathered output blocks' table rows (padding clamped to the
    trash row), one index tensor a local position."""
    gathered = all_gather(side_rows, axis=None, mesh=mesh)
    return tuple(torch.clamp(g.long(), max=n_rows_padded)
                 for g in gathered)


def _block_of(n_live: int, L: int, params: ALSParams) -> int:
    return params.block_rows or _auto_block_rows(n_live, L, params.rank)


def _mesh_side_of(h, n_real: int, mesh: DeviceMesh,
                  params: ALSParams) -> MeshSide:
    """A one-process mesh's :class:`MeshSide` cut from a side packed
    whole (rows padded to the mesh size) on the mesh's first device."""
    if isinstance(h, MeshSide):
        return h
    if isinstance(h, SplitHistories):
        return _mesh_side_split(h, mesh, params)
    n_dev = mesh.size
    local = mesh.local_positions()
    pieces: List[List[_Piece]] = [[] for _ in local]
    if isinstance(h, BucketedHistories):
        rows_out: List[List[torch.Tensor]] = [[] for _ in local]
        off = 0
        for bk in h.buckets:
            npb = bk.n_rows // n_dev
            n_live = int((bk.row_ids < h.n_rows).sum().item())
            block = _block_of(n_live, bk.length, params)
            for k, p in enumerate(local):
                dev = mesh.devices[p]
                sl = slice(p * npb, (p + 1) * npb)
                pieces[k] += _cut_position(
                    bk.indices[sl].to(dev), bk.values[sl].to(dev),
                    bk.counts[sl].to(dev), p * npb, n_live, block, off)
                rows_out[k].append(bk.row_ids[sl].to(dev))
            off += npb
        n_pad = h.n_rows_padded
        rows = [torch.cat(r) if r else torch.empty(0, dtype=torch.int32,
                                                   device=mesh.devices[p])
                for r, p in zip(rows_out, local)]
        return MeshSide("bucket", h.n_rows, n_pad, off,
                        tuple(tuple(x) for x in pieces),
                        _mesh_dst(rows, mesh, n_pad))
    n_pad = h.n_rows
    n_per = n_pad // n_dev
    block = _block_of(n_real, h.max_len, params)
    for k, p in enumerate(local):
        dev = mesh.devices[p]
        sl = slice(p * n_per, (p + 1) * n_per)
        pieces[k] = _cut_position(h.indices[sl].to(dev),
                                  h.values[sl].to(dev),
                                  h.counts[sl].to(dev), p * n_per, n_real,
                                  block, 0)
    return MeshSide("pad", n_real, n_pad, n_per,
                    tuple(tuple(x) for x in pieces),
                    tuple(None for _ in local))


def _mesh_side_split(h: SplitHistories, mesh: DeviceMesh,
                     params: ALSParams) -> MeshSide:
    """The split layout's :class:`MeshSide` over a one-process mesh.

    The single card's blocks (``block_rows``, or the auto size of the
    unpadded virtual rows) are dealt out whole, an even share of blocks
    a position in order, and each block is one piece: the single card's
    ``fused_gram`` launch and :func:`_segment_sum` call on the same
    rows. A position solves the real rows whose first virtual row it
    holds (rows with no virtual row go with the rows before them), so a
    real row whose virtual rows run on into a later position's blocks
    takes that position's segment sum after its own, in block order
    (:func:`_mesh_split_solve`): every real row's sum is added in the
    single card's order. ``row_cuts[p]`` is position p's first real
    row."""
    n_dev = mesh.size
    owners = h.row_ids.cpu().numpy().astype(np.int64)
    n_live = int(np.searchsorted(owners, h.n_rows))  # padding is last
    block = _block_of(max(n_live, 1), h.max_len, params)
    starts = list(range(0, n_live, block))
    first = [p * len(starts) // n_dev for p in range(n_dev + 1)]
    n_pad = h.n_rows_padded
    cuts = [0] + [int(owners[starts[first[p]] - 1]) + 1 if first[p] else 0
                  for p in range(1, n_dev)] + [n_pad]
    width = max(cuts[p + 1] - cuts[p] for p in range(n_dev))
    local = mesh.local_positions()
    pieces: List[List[_Piece]] = [[] for _ in local]
    dst_rows, counts = [], []
    for k, p in enumerate(local):
        dev = mesh.devices[p]
        for s in starts[first[p]:first[p + 1]]:
            e = min(s + block, n_live)
            pieces[k].append(_Piece(
                h.indices[s:e].to(dev), h.values[s:e].to(dev),
                h.counts[s:e].to(dev), 0, e - s, owners[s:e]))
        r0, r1 = cuts[p], cuts[p + 1]
        counts.append(h.real_counts[r0:r1].to(dev))
        dst_rows.append(torch.arange(r0, r0 + width, dtype=torch.int64,
                                     device=dev))
        dst_rows[-1][r1 - r0:] = n_pad
    return MeshSide("split", h.n_rows, n_pad, width,
                    tuple(tuple(x) for x in pieces),
                    _mesh_dst(dst_rows, mesh, n_pad), tuple(counts),
                    tuple(cuts))


def _split_accumulate(src: torch.Tensor, pieces: Sequence[_Piece],
                      row0: int, n: int, params: ALSParams):
    """One mesh position's split partials: each piece's partials (one
    ``fused_gram`` launch) and segment sums, the single card's calls on
    that block, added onto the position's real rows ``[row0, row0 +
    n)`` in piece order. Returns ``(A_acc, b_acc, carries)``: a piece
    whose first segment belongs to a real row an earlier position
    solves hands that segment's sums back as ``(row, A, b)``, in
    order."""
    r = src.shape[-1]
    A_acc = torch.zeros((n, r, r), dtype=torch.float32, device=src.device)
    b_acc = torch.zeros((n, r), dtype=torch.float32, device=src.device)
    carries = []
    for pc in pieces:
        A_v, b_v = _partials_block(
            src, pc.indices, pc.values, pc.counts, params.alpha,
            params.implicit_prefs, params.matmul_dtype == "bfloat16",
            params.gram_mode)
        rows, A_s = _segment_sum(A_v, pc.owners)
        _, b_s = _segment_sum(b_v, pc.owners)
        lo = int(rows[0] < row0)
        if lo:
            carries.append((int(rows[0]), A_s[0], b_s[0]))
        dst = torch.from_numpy(rows[lo:] - row0).to(src.device)
        A_acc[dst] += A_s[lo:]
        b_acc[dst] += b_s[lo:]
    return A_acc, b_acc, carries


def _mesh_split_solve(accs: list, G: List[Optional[torch.Tensor]],
                      side: MeshSide, params: ALSParams
                      ) -> List[torch.Tensor]:
    """Finish a split half-step over a mesh: every carried segment sum
    added onto its real row's accumulator in position order (a
    position's own in piece order), after the owner's own blocks, so a
    row's blocks add in turn as on the single card; then one solve a
    position that holds rows (one ``chol_solve`` launch). Returns each
    position's ``[block_rows_out, r]`` output block."""
    cuts = side.row_cuts
    for _, _, carries in accs:
        for row, A_c, b_c in carries:
            q = bisect.bisect_right(cuts, row) - 1
            A_q, b_q, _ = accs[q]
            A_q[row - cuts[q]] += A_c.to(A_q.device)
            b_q[row - cuts[q]] += b_c.to(b_q.device)
    outs = []
    for k, (A, b, _) in enumerate(accs):
        out = torch.zeros((side.block_rows_out, b.shape[-1]),
                          dtype=torch.float32, device=b.device)
        if b.shape[0]:
            out[:b.shape[0]] = _solve_accumulated(
                A, b, G[k], side.real_counts[k], params.reg,
                params.scale_reg_by_count)
        outs.append(out)
    return outs


def _mesh_half_step(fixed: List[torch.Tensor], side: MeshSide,
                    params: ALSParams, mesh: DeviceMesh,
                    n_fixed: Optional[int] = None) -> List[torch.Tensor]:
    """One half-iteration over a mesh: ``fixed`` is the whole fixed
    table on each local position's device (one tensor a device), whose
    first ``n_fixed`` rows are real; returns the whole updated table the
    same way, after the all-gather. The implicit Gramian is made once a
    device from its whole table (:func:`_fixed_side_gramian`)."""
    r = fixed[0].shape[-1]
    G: List[Optional[torch.Tensor]] = [None] * len(fixed)
    if params.implicit_prefs:
        grams: dict = {}
        for k, f in enumerate(fixed):
            if id(f) not in grams:
                grams[id(f)] = _fixed_side_gramian(f, n_fixed)
            G[k] = grams[id(f)]
    shadows: dict = {}
    outs = []
    for k, f in enumerate(fixed):
        src = f
        if params.gather_dtype == "bfloat16":
            if id(f) not in shadows:
                shadows[id(f)] = f.bfloat16()
            src = shadows[id(f)]
        if side.kind == "split":  # accumulators now, solved below
            outs.append(_split_accumulate(
                src, side.pieces[k], side.row_cuts[k],
                int(side.real_counts[k].shape[0]), params))
            continue
        out = torch.zeros((side.block_rows_out, r), dtype=torch.float32,
                          device=f.device)
        for pc in side.pieces[k]:
            out[pc.offset:pc.offset + pc.indices.shape[0]] = _update_block(
                src, G[k], pc.indices, pc.values, pc.counts, params.reg,
                params.alpha, params.implicit_prefs,
                params.scale_reg_by_count,
                bf16=params.matmul_dtype == "bfloat16",
                gram=params.gram_mode, plan_rows=pc.plan_rows)
        outs.append(out)
    if side.kind == "split":
        outs = _mesh_split_solve(outs, G, side, params)
    with torch.profiler.record_function("ptpu.all_gather"):
        gathered = all_gather(outs, axis=None, mesh=mesh)
        if side.kind == "pad":
            return gathered
        tables: dict = {}
        for g, dst in zip(gathered, side.dst):
            if id(g) not in tables:
                t = torch.zeros((side.n_rows_padded + 1, r),
                                dtype=torch.float32, device=g.device)
                t.index_copy_(0, dst, g)
                tables[id(g)] = t[:side.n_rows_padded]
        return [tables[id(g)] for g in gathered]


def pack_ratings_multihost(ratings, params: ALSParams, mesh: DeviceMesh,
                           force: bool = False) -> PackedRatings:
    """Packing for a process mesh: every process packs only the history
    rows its own positions update, on its first local device, straight
    into their :class:`MeshSide` blocks. A one-process mesh (unless
    ``force``) goes to :func:`pack_ratings`.

    ``ratings`` is a :class:`RatingsCOO` every process holds, or a
    sharded source (``read_rows`` / ``read_row_mask`` / ``row_counts``,
    ``models/data.py``) from which each process materializes only its
    rows' triples. Layouts: "auto" resolves per side as one process's
    packing does (:func:`_auto_layout`; the bucketed layout's buckets
    split evenly over the positions); "split" maps to an uncapped
    bucketed layout."""
    if not mesh.spans_processes and not force:
        return pack_ratings(ratings, params, mesh=mesh)
    n_dev = mesh.size
    mine = list(mesh.local_positions())
    if not mine:
        raise ValueError("this process owns no position of the mesh; "
                         "build the mesh over every process's devices")
    if mine != list(range(mine[0], mine[-1] + 1)):
        raise ValueError("pack_ratings_multihost needs each process's "
                         "positions contiguous in mesh order")
    is_source = hasattr(ratings, "read_rows")
    sides = {}
    for side, n_rows in (("user", ratings.n_users),
                         ("item", ratings.n_items)):
        if is_source:
            counts = np.asarray(ratings.row_counts(side))
        else:
            rows_g = ratings.users if side == "user" else ratings.items
            counts = np.bincount(rows_g, minlength=n_rows)
        mode = params.history_mode
        cap = params.max_history and int(params.max_history)
        if mode == "split":
            mode, cap = "bucket", None
        elif mode == "auto":
            mode = "pad" if params.max_history is not None \
                else _auto_layout(counts, n_rows, int(counts.sum()))

        pack = _pack_side_bucket_multihost if mode == "bucket" \
            else _pack_side_pad_multihost
        sides[side] = pack(_SideReader(ratings, side), counts, n_rows,
                           mesh, mine, cap, params)
    return PackedRatings(user_h=sides["user"], item_h=sides["item"],
                         n_users=ratings.n_users, n_items=ratings.n_items,
                         mesh=mesh)


class _SideReader:
    """One side's triples, ``(rows, cols, values)`` in storage order, of
    a row range or a row set: from a sharded source's reads, or by
    selection from a COO every process holds."""

    def __init__(self, ratings, side: str):
        self.ratings, self.side = ratings, side

    def _take(self, pick):
        r = self.ratings
        rows = r.users if self.side == "user" else r.items
        cols = r.items if self.side == "user" else r.users
        sel = pick(rows)
        return rows[sel], cols[sel], np.asarray(r.ratings)[sel]

    def rows(self, start: int, stop: int):
        if hasattr(self.ratings, "read_rows"):
            return self.ratings.read_rows(self.side, start, stop)
        return self._take(lambda r: (r >= start) & (r < stop))

    def row_set(self, mask: np.ndarray):
        if hasattr(self.ratings, "read_row_mask"):
            return self.ratings.read_row_mask(self.side, mask)
        return self._take(lambda r: mask[r])


def _pack_side_pad_multihost(reader: _SideReader, counts, n_rows, mesh,
                             mine, cap, params) -> MeshSide:
    """One side's pad layout, this process's rows only: rows ``[start,
    stop)`` of this process's positions, read and packed locally."""
    n_dev = mesh.size
    L = resolve_max_len(counts, n_rows, cap)
    n_pad = -(-n_rows // n_dev) * n_dev
    n_per = n_pad // n_dev
    start, stop = mine[0] * n_per, (mine[-1] + 1) * n_per
    rows_l, cols_l, vals_l = reader.rows(start, min(stop, n_rows))
    dev = mesh.devices[mine[0]]
    local = pack_histories_device(np.asarray(rows_l) - start, cols_l,
                                  vals_l, stop - start, L, device=dev)
    block = _block_of(n_rows, L, params)
    pieces = []
    for k, p in enumerate(mine):
        sl = slice(k * n_per, (k + 1) * n_per)
        d = mesh.devices[p]
        pieces.append(tuple(_cut_position(
            local.indices[sl].to(d), local.values[sl].to(d),
            local.counts[sl].to(d), p * n_per, n_rows, block, 0)))
    return MeshSide("pad", n_rows, n_pad, n_per, tuple(pieces),
                    tuple(None for _ in mine))


def _pack_side_bucket_multihost(reader: _SideReader, counts, n_rows, mesh,
                                mine, cap, params) -> MeshSide:
    """One side of the drop-free bucketed layout, this process's rows
    only: every process plans the same buckets from the same global
    ``counts`` (each padded to the mesh size and cut evenly over the
    positions), then reads and packs only the bucket rows its positions
    own (a row set: bucket membership is by history length)."""
    from ..ops.ragged import _pack_flat, bucket_layout

    n_dev = mesh.size
    if cap is not None:
        counts = np.minimum(counts, int(cap))
    plan, _, _ = bucket_layout(counts, min_len=8, pad_rows_to=n_dev)
    n_rows_pad = max(-(-n_rows // n_dev) * n_dev, n_dev)
    d_loc = len(mine)
    local_base = np.zeros(n_rows, dtype=np.int64)
    owned = np.zeros(n_rows, dtype=bool)
    spans, off_loc = [], 0
    for L, rows_k, n_bk_pad, _ in plan:
        npb = n_bk_pad // n_dev
        lo, hi = mine[0] * npb, (mine[-1] + 1) * npb
        rows_local = rows_k[lo:min(hi, len(rows_k))]
        local_base[rows_local] = off_loc + np.arange(
            len(rows_local), dtype=np.int64) * int(L)
        owned[rows_local] = True
        rid = (n_rows_pad + np.arange(n_bk_pad, dtype=np.int64)
               - len(rows_k)).astype(np.int32)
        rid[:len(rows_k)] = rows_k
        spans.append((int(L), rows_k, npb, off_loc, rid))
        off_loc += d_loc * npb * int(L)
    if off_loc >= 2 ** 31:
        raise ValueError(f"the bucketed layout needs {off_loc} local slots "
                         f"(past int32); use more processes or cap "
                         f"max_history")
    rows_l, cols_l, vals_l = reader.row_set(owned)
    dev = mesh.devices[mine[0]]
    flat_idx, flat_val = _pack_flat(np.asarray(rows_l), cols_l, vals_l,
                                    local_base, counts, n_rows,
                                    max(off_loc, 1), dev)
    pieces = [[] for _ in mine]
    rows_out = [[] for _ in mine]
    off_out = 0
    for L, rows_k, npb, off, rid in spans:
        block = _block_of(len(rows_k), L, params)
        for k, p in enumerate(mine):
            d = mesh.devices[p]
            base = off + k * npb * L
            own = rows_k[p * npb:(p + 1) * npb]
            cnt = np.zeros(npb, dtype=np.int32)
            cnt[:len(own)] = counts[own]
            pieces[k] += _cut_position(
                flat_idx[base:base + npb * L].view(npb, L).to(d),
                flat_val[base:base + npb * L].view(npb, L).to(d),
                torch.from_numpy(cnt).to(d), p * npb, len(rows_k), block,
                off_out)
            rows_out[k].append(torch.from_numpy(
                np.ascontiguousarray(rid[p * npb:(p + 1) * npb])).to(d))
        off_out += npb
    rows = [torch.cat(r) if r else torch.empty(0, dtype=torch.int32,
                                               device=mesh.devices[p])
            for r, p in zip(rows_out, mine)]
    return MeshSide("bucket", n_rows, n_rows_pad, off_out,
                    tuple(tuple(x) for x in pieces),
                    _mesh_dst(rows, mesh, n_rows_pad))


def _replicate(table: torch.Tensor, mesh: DeviceMesh) -> List[torch.Tensor]:
    """A whole host table on every local position's device, one copy a
    device."""
    memo: dict = {}
    for p in mesh.local_positions():
        dev = mesh.devices[p]
        if str(dev) not in memo:
            memo[str(dev)] = table.to(dev)
    return [memo[str(mesh.devices[p])] for p in mesh.local_positions()]


def _row_sharded(tables: List[torch.Tensor], mesh: DeviceMesh
                 ) -> RowShardedTable:
    """The whole table every process holds after training, cut into the
    mesh's row shards: a local position's shard on its device, another
    process's on this process's first local device."""
    local = mesh.local_positions()
    whole = tables[0]
    n_loc = whole.shape[0] // mesh.size
    shards = []
    for p in range(mesh.size):
        dev = mesh.devices[p] if p in local else whole.device
        src = tables[local.index(p)] if p in local else whole
        shards.append(tag_position(
            src[p * n_loc:(p + 1) * n_loc].to(dev, copy=True), p))
    return RowShardedTable(tuple(shards), mesh)


def _rows_padded(h) -> int:
    return h.n_rows_padded if isinstance(h, (BucketedHistories,
                                             SplitHistories)) else h.n_rows


def draw_initial_factors(seed: int, n_users: int, n_users_padded: int,
                         n_items: int, n_items_padded: int, rank: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MLlib-style init on the host: N(0, 1) / sqrt(rank) for the real
    rows, drawn user table first from a ``torch.Generator`` seeded with
    ``seed``, zeros for padding rows (they stay zero: their b is 0)."""
    gen = torch.Generator().manual_seed(int(seed))

    def one(n, n_pad):
        f = torch.zeros((n_pad, rank), dtype=torch.float32)
        f[:n] = torch.randn((n, rank), generator=gen,
                            dtype=torch.float32) / math.sqrt(rank)
        return f

    return one(n_users, n_users_padded), one(n_items, n_items_padded)


def _init_table(arr, n_real: int, n_padded: int, rank: int,
                which: str) -> torch.Tensor:
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim != 2 or arr.shape[1] != rank \
            or not n_real <= arr.shape[0] <= n_padded:
        raise ValueError(f"init {which} factors must be [n, {rank}] with "
                         f"{n_real} <= n <= {n_padded}, got {arr.shape}")
    f = torch.zeros((n_padded, rank), dtype=torch.float32)
    f[:arr.shape[0]] = torch.from_numpy(arr.copy())
    return f


def checkpoint_fingerprints(ratings: RatingsCOO, params: ALSParams,
                            pad_layout: bool) -> Tuple[str, ...]:
    """The fingerprints a checkpoint directory of this run may carry, the
    JAX package's bit for bit: the first is this run's (the params and
    problem dims that set the factor trajectory, ``history_mode``, the
    bf16 shadow when on, and a digest of the ratings: their first and
    last 1,024 triples in their own dtypes plus float64 sums); a run
    whose both sides pad also accepts the older pad-only fingerprint."""
    k = 1024
    content = hashlib.sha256()
    for arr in (np.asarray(ratings.users), np.asarray(ratings.items),
                np.asarray(ratings.ratings)):
        content.update(np.ascontiguousarray(arr[:k]).tobytes())
        content.update(np.ascontiguousarray(arr[-k:]).tobytes())
        content.update(np.float64(arr.sum(dtype=np.float64)).tobytes())
    legacy_base = [
        params.rank, params.reg, params.alpha, params.implicit_prefs,
        params.seed, params.scale_reg_by_count, params.matmul_dtype,
        params.max_history, ratings.n_users, ratings.n_items,
        len(ratings.users),
    ]
    base = legacy_base + [params.history_mode]
    if params.gather_dtype != "float32":
        base = base + [params.gather_dtype]
    out = (hashlib.sha256(json.dumps(
        base + [content.hexdigest()]).encode()).hexdigest()[:16],)
    if pad_layout:
        out += (hashlib.sha256(
            json.dumps(legacy_base).encode()).hexdigest()[:16],)
    return out


def _open_checkpoint(checkpoint_dir: str, ratings: Optional[RatingsCOO],
                     params: ALSParams, user_h, item_h):
    """The run's checkpointer (``make_checkpointer``: the distributed one
    in a process group of several): refuses a directory another run
    (params, data or history layout) wrote, then records this run's
    fingerprint."""
    from ..workflow.checkpoint import make_checkpointer

    if ratings is None:
        raise ValueError("checkpointing fingerprints the ratings content; "
                         "pass the ratings with packed= when using "
                         "checkpoint_dir")
    if hasattr(ratings, "read_rows"):
        raise ValueError("checkpointing fingerprints the ratings content; "
                         "pass a RatingsCOO (source.to_coo()) when using "
                         "checkpoint_dir")
    accepted = checkpoint_fingerprints(
        ratings, params, isinstance(user_h, PaddedHistories)
        and isinstance(item_h, PaddedHistories))
    ckpt = make_checkpointer(checkpoint_dir)
    meta = ckpt.get_metadata()
    if meta is not None and meta.get("fingerprint") not in accepted:
        raise ValueError(
            f"checkpoint dir {checkpoint_dir} belongs to a different ALS "
            f"run (params/dataset/history-layout mismatch); use a fresh "
            f"dir")
    ckpt.set_metadata({"fingerprint": accepted[0]})
    return ckpt


def _half_step(h) -> Callable:
    """The half-step function of a packed side's layout."""
    return _update_side_split if isinstance(h, SplitHistories) \
        else _update_side


def train_als(ratings: Optional[RatingsCOO], params: ALSParams, *,
              device: DeviceLike = None,
              mesh: Optional[DeviceMesh] = None,
              init: Optional[Tuple[np.ndarray, np.ndarray]] = None,
              packed: Optional[PackedRatings] = None,
              checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 0):
    """Run ALS on ``device`` (the card by default; ``"cpu"`` runs every
    kernel's plain version); returns ``(user_factors, item_factors)`` f32
    with padded rows.

    ``init`` is optional initial factors ``(U0, V0)`` as host arrays
    (real rows, or real plus padding rows). Without it the factors are
    drawn by :func:`draw_initial_factors` from ``params.seed``. The JAX
    package draws with ``jax.random``, which torch cannot reproduce, so a
    parity run passes the JAX package's own draw in here. ``packed``
    (from :func:`pack_ratings` with the same params and device or mesh)
    skips the packing; with it ``ratings`` may be None. ``ratings`` may
    also be a sharded source (``models/data.py``). Each iteration is a
    user half-step then an item half-step, as Python loops.

    With a ``mesh`` (``parallel/mesh.py``: ``make_mesh``, or
    ``multihost.global_mesh`` over several processes) each side's rows
    are padded to the mesh's size and every position updates its block
    of them, from the whole fixed side on its device, all-gathered once
    a half-step (module section "training over a mesh"); the factors
    come back as :class:`RowShardedTable`\\ s over the mesh. The draw
    (or ``init``) is the single device's, cut into shards, so a mesh run
    starts from the single device's tables and gives the single device's
    factors bit for bit on the card, explicit and implicit (each device
    takes the implicit Gramian over the whole fixed side, as the single
    device does). The split layout trains over a mesh of one process
    (:func:`_mesh_side_split`), bitwise the single device's too; a
    process mesh packs it as the bucketed layout, as the JAX package
    does.

    With ``checkpoint_dir`` the factors are saved every
    ``checkpoint_every`` iterations (a directory implies 1) and a
    restarted call resumes from the newest restorable step no later than
    ``num_iterations``: a torn step is skipped, and a directory another
    run wrote (:func:`checkpoint_fingerprints`) is refused. Checkpointing
    needs the ratings as a :class:`RatingsCOO` (the fingerprint digests
    them). The kernels add in a fixed order, so a resumed run's factors
    are bitwise those of an uninterrupted one."""
    if ratings is None:
        if packed is None:
            raise ValueError("train_als(ratings=None) needs packed= (from "
                             "pack_ratings or pack_ratings_multihost)")
    elif hasattr(ratings, "read_rows"):
        if ratings.n_users == 0 or ratings.n_items == 0:
            raise ValueError("ALS requires a non-empty ratings matrix "
                             "(0 users/items in the source)")
    elif len(ratings.users) == 0 or ratings.n_users == 0 \
            or ratings.n_items == 0:
        raise ValueError("ALS requires a non-empty ratings matrix "
                         "(0 entries/users/items given)")
    if mesh is not None:
        return _train_als_mesh(ratings, params, mesh, init, packed,
                               checkpoint_dir, checkpoint_every)
    dev = resolve_device(device)
    if packed is None:
        packed = pack_ratings(ratings, params, dev)
    user_h, item_h = packed
    n_u, n_i = packed.n_users, packed.n_items
    u_pad, i_pad = _rows_padded(user_h), _rows_padded(item_h)
    U, V = _initial_tables(params, init, n_u, u_pad, n_i, i_pad)
    U, V = U.to(dev), V.to(dev)
    step_u, step_i = _half_step(user_h), _half_step(item_h)
    ckpt, start = None, 0
    if checkpoint_dir:
        ckpt = _open_checkpoint(checkpoint_dir, ratings, params, user_h,
                                item_h)
        checkpoint_every = checkpoint_every if checkpoint_every > 0 else 1
    try:
        if ckpt is not None:
            start, state = ckpt.restore_latest(
                like={"U": U, "V": V}, max_step=params.num_iterations)
            if state is not None:
                U = torch.as_tensor(state["U"]).to(dev)
                V = torch.as_tensor(state["V"]).to(dev)
        for it in range(start, params.num_iterations):
            U = step_u(V, user_h, params, n_i)
            V = step_i(U, item_h, params, n_u)
            if ckpt is not None:
                ckpt.maybe_save(it + 1, {"U": U, "V": V},
                                every=checkpoint_every)
    finally:
        if ckpt is not None:
            ckpt.close()
    return U, V


def _initial_tables(params: ALSParams, init, n_u: int, u_pad: int,
                    n_i: int, i_pad: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The host tables a training starts from: ``init``, or the seeded
    draw (its real rows depend only on the real row counts)."""
    if init is None:
        return draw_initial_factors(params.seed, n_u, u_pad, n_i, i_pad,
                                    params.rank)
    return (_init_table(init[0], n_u, u_pad, params.rank, "user"),
            _init_table(init[1], n_i, i_pad, params.rank, "item"))


def _train_als_mesh(ratings, params: ALSParams, mesh: DeviceMesh, init,
                    packed: Optional[PackedRatings], checkpoint_dir,
                    checkpoint_every: int):
    """:func:`train_als` over a mesh (one process's or several's)."""
    if packed is None:
        packed = pack_ratings(ratings, params, mesh=mesh)
    elif packed.mesh is None or packed.mesh.devices != mesh.devices \
            or packed.mesh.ranks != mesh.ranks:
        raise ValueError("packed= was packed for another mesh (or none); "
                         "pack with pack_ratings(..., mesh=mesh)")
    us = packed.mesh_side("user", params)
    its = packed.mesh_side("item", params)
    U0, V0 = _initial_tables(params, init, packed.n_users,
                             us.n_rows_padded, packed.n_items,
                             its.n_rows_padded)
    ckpt, start = None, 0
    if checkpoint_dir:
        ckpt = _open_checkpoint(checkpoint_dir, ratings, params,
                                packed.user_h, packed.item_h)
        checkpoint_every = checkpoint_every if checkpoint_every > 0 else 1
    from ..workflow.checkpoint import DistributedCheckpointer

    sharded_state = isinstance(ckpt, DistributedCheckpointer)
    try:
        if ckpt is not None:
            start, state = ckpt.restore_latest(
                like={"U": U0, "V": V0}, max_step=params.num_iterations)
            if state is not None:
                U0 = torch.as_tensor(np.asarray(state["U"]))
                V0 = torch.as_tensor(np.asarray(state["V"]))
        U = _replicate(U0, mesh)
        V = _replicate(V0, mesh)
        for it in range(start, params.num_iterations):
            U = _mesh_half_step(V, us, params, mesh, packed.n_items)
            V = _mesh_half_step(U, its, params, mesh, packed.n_users)
            if ckpt is not None:
                state = ({"U": _row_sharded(U, mesh),
                          "V": _row_sharded(V, mesh)} if sharded_state
                         else {"U": U[0], "V": V[0]})
                ckpt.maybe_save(it + 1, state, every=checkpoint_every)
    finally:
        if ckpt is not None:
            ckpt.close()
    return _row_sharded(U, mesh), _row_sharded(V, mesh)


def als_flops_per_iter(user_h, item_h, params: ALSParams) -> int:
    """Padded-work FLOP model of one full iteration (both half-steps),
    padding slots included: A outer products ``2 * padded * r^2``, b
    products ``2 * padded * r``, the fixed-side Gramian
    ``2 * rows_fixed * r^2`` (implicit only), and per solved row a
    Cholesky ``r^3 / 3`` plus two triangular solves ``2 r^2``."""
    r = params.rank

    def side(h, fixed_rows: int) -> int:
        if isinstance(h, BucketedHistories):
            padded = h.padded_entries
            n_solve = sum(b.n_rows for b in h.buckets)
        elif isinstance(h, SplitHistories):
            padded = h.n_virtual * h.max_len
            n_solve = h.n_rows_padded
        else:
            padded = h.n_rows * h.max_len
            n_solve = h.n_rows
        f = 2 * padded * r * r + 2 * padded * r
        if params.implicit_prefs:
            f += 2 * fixed_rows * r * r
        f += n_solve * (r ** 3 // 3 + 2 * r * r)
        return f

    return (side(user_h, _rows_padded(item_h))
            + side(item_h, _rows_padded(user_h)))



# -- streaming fold-in ------------------------------------------------------
#
# The primitives the stream trainer (``streaming/``) folds fresh events in
# with: per-entity regularized least-squares solves against the FIXED
# opposite factor table, one half-iteration of ALS restricted to the
# touched rows. Each row is re-solved from its FULL history, so folding
# the same events in twice lands on the same row: replay after a crash is
# idempotent.

def dequantize_table(t: AnyTable):
    """An f32 view of a factor table on its own device (identity for a
    plain f32 table): what a fold-in solves against, the values the
    table serves. A row-sharded table dequantizes shard by shard and
    stays sharded."""
    if isinstance(t, RowShardedTable):
        return RowShardedTable(tuple(dequantize_table(s) for s in t.shards),
                               t.mesh)
    if not isinstance(t, QuantizedFactors):
        return t
    if t.scale is None:
        return t.data.float()
    return t.data.float() * t.scale


def dedupe_pairs(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Collapse repeated ``(row, col)`` pairs to the LAST value
    (last-write-wins, in input order). A burst of identical events must
    not multiply a pair's weight in the normal equations: the batch
    trainer's input is one rating per (user, item)."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    if len(rows) == 0:
        return rows, cols, vals
    # np.unique keeps the FIRST occurrence per key; index from the back
    # so "first of reversed" is the last write
    key = np.stack([rows[::-1], cols[::-1]], axis=1)
    _, first_of_rev = np.unique(key, axis=0, return_index=True)
    keep = np.sort(len(rows) - 1 - first_of_rev)
    return rows[keep], cols[keep], vals[keep]


def _sharded_gramian(fixed: RowShardedTable) -> torch.Tensor:
    """``F^T F`` of a row-sharded table: each shard's Gramian (its zero
    padding adds nothing), summed in shard order on the first shard's
    device (the JAX package's all-reduce of per-shard partials)."""
    dev = fixed.device
    G = None
    for shard in dequantize_table(fixed).shards:
        part = gramian(shard).to(dev)
        G = part if G is None else G + part
    return G


def fixed_gramian(fixed: AnyTable, params: ALSParams
                  ) -> Optional[torch.Tensor]:
    """The implicit path's Gramian ``F^T F`` of the fixed side, for
    callers that reuse it across fold-in micro-batches (it depends only
    on the fixed table). ``None`` for explicit models."""
    if not params.implicit_prefs:
        return None
    if isinstance(fixed, RowShardedTable):
        with _mesh_dispatch_lock:
            return _sharded_gramian(fixed)
    return gramian(dequantize_table(fixed))


def _fold_in_solve(table: torch.Tensor, indices: np.ndarray,
                   values: np.ndarray, counts: np.ndarray,
                   params: ALSParams, G: Optional[torch.Tensor]
                   ) -> np.ndarray:
    """:func:`fold_in_rows`'s solve against one f32 table on its device."""
    B, L = indices.shape
    if L == 0:  # every row empty: one masked slot keeps the shapes legal
        indices = np.zeros((B, 1), np.int32)
        values = np.zeros((B, 1), np.float32)
    dev = table.device
    idx = torch.from_numpy(np.ascontiguousarray(indices)).to(dev)
    val = torch.from_numpy(np.ascontiguousarray(values)).to(dev)
    cnt = torch.from_numpy(counts).to(dev)
    implicit = params.implicit_prefs
    if implicit and G is None:
        G = gramian(table)
    gsrc = table.bfloat16() if params.gather_dtype == "bfloat16" else table
    # debug_numerics sweeps the solved rows on their device (a NaN is
    # attributed HERE, before a hot-swap can poison the serving table); a
    # pass-through one bool check when off
    new = _numerics.checked_call(
        "fold_in_rows", _update_block, gsrc, G, idx, val, cnt, params.reg,
        params.alpha, implicit, params.scale_reg_by_count,
        bf16=params.matmul_dtype == "bfloat16", gram=params.gram_mode)
    return new.cpu().numpy().astype(np.float32, copy=False)


def fold_in_rows(fixed: AnyTable, indices: np.ndarray, values: np.ndarray,
                 counts: np.ndarray, params: ALSParams,
                 G: Optional[torch.Tensor] = None) -> np.ndarray:
    """Solve ``B`` rows' normal equations against the fixed opposite
    table, on the table's device: the streaming increment. Goes through
    :func:`_update_block`, so the fold-in shares ``fused_gram`` and
    ``chol_solve`` (or their plain versions for a CPU table), the bf16
    gather shadow and the explicit/implicit weights with the batch
    trainer.

    ``indices`` / ``values`` are ``[B, L]`` host histories (padding
    slots carry any index and are masked by ``counts``). The JAX package
    pads B and L to powers of two to reuse compilations; nothing here is
    compiled per shape, so the arrays go to the card as they are. ``G``
    is a precomputed :func:`fixed_gramian` (implicit only). Returns host
    ``[B, rank]`` f32 rows.

    Against a row-sharded table the rows the histories name are gathered
    from their owner shards into one compact f32 table on the first
    shard's device, the indices renumbered into it, and the same solve
    runs there: the same rows in the same order, so the same answer as
    against the whole table."""
    indices = np.asarray(indices, dtype=np.int32)
    values = np.asarray(values, dtype=np.float32)
    counts = np.asarray(counts, dtype=np.int32)
    B = indices.shape[0]
    if isinstance(fixed, RowShardedTable):
        r = fixed.shape[1]
        if B == 0:
            return np.zeros((0, r), np.float32)
        if params.implicit_prefs and G is None:
            G = fixed_gramian(fixed, params)
        with _mesh_dispatch_lock:
            uniq, local = np.unique(indices, return_inverse=True)
            vecs, scale = _user_vecs(fixed, uniq, fixed.device)
            compact = vecs.float() if scale is None \
                else vecs.float() * scale
            # ptpu: allow[blocking-under-lock] — the fold-in's gather and
            # launches against the shards are one sharded dispatch, as the
            # JAX package's is
            return _fold_in_solve(
                compact, local.reshape(indices.shape).astype(np.int32),
                values, counts, params, G)
    table = dequantize_table(fixed)
    if not isinstance(table, torch.Tensor):
        raise TypeError(f"the fixed table must be a torch tensor or "
                        f"QuantizedFactors, got {type(fixed).__name__}")
    if B == 0:
        return np.zeros((0, table.shape[-1]), np.float32)
    return _fold_in_solve(table, indices, values, counts, params, G)


def _write_rows(table: torch.Tensor, row_idx: torch.Tensor,
                rows: torch.Tensor) -> torch.Tensor:
    """A copy of ``table`` with ``rows`` at ``row_idx``: never a write
    into a tensor an in-flight batch may still read."""
    new = table.clone()
    new.index_copy_(0, row_idx, rows.to(new.device, new.dtype))
    return new


def _write_table_rows(table: Table, row_idx: np.ndarray, rows: np.ndarray
                      ) -> Table:
    """:func:`_write_rows` on a plain or quantized table: a quantized one
    re-quantizes the f32 rows, and its data and scales swap together."""
    data, scale = _table_leaves(table)
    idx = torch.from_numpy(row_idx).to(data.device)
    if isinstance(table, QuantizedFactors):
        # ptpu: allow[quantize-without-parity-gate] — apply_row_updates'
        # requantize seam (its only caller, also through
        # _write_sharded_rows): the new rows take the quant the gate
        # already chose for this table, and data and scale swap together
        qd, qs = _quantize_rows(rows, table.quant)
        return QuantizedFactors(
            _write_rows(data, idx, qd),
            None if scale is None else _write_rows(scale, idx, qs),
            table.quant)
    return _write_rows(data, idx, torch.from_numpy(rows))


def _write_sharded_rows(table: RowShardedTable, row_idx: np.ndarray,
                        rows: np.ndarray) -> RowShardedTable:
    """A new row-sharded table with ``rows`` at ``row_idx``: each row
    written into a copy of its owner shard; untouched shards are shared."""
    n_local = table.n_local
    shards = list(table.shards)
    owner = row_idx // n_local
    for s in np.unique(owner):
        pos = np.flatnonzero(owner == s)
        shards[int(s)] = _write_table_rows(
            shards[int(s)], row_idx[pos] - int(s) * n_local, rows[pos])
    return RowShardedTable(tuple(shards), table.mesh)


def apply_row_updates(model: ALSModel, side: str, row_idx: np.ndarray,
                      rows: np.ndarray) -> ALSModel:
    """A NEW model with ``side``'s factor rows at ``row_idx`` replaced
    by ``rows``: the delta the stream trainer hot-swaps into the serving
    binding. Functional: the input model, possibly still bound and
    serving, is never written. A quantized table re-quantizes the f32
    rows on the way in, and its data and per-row scales swap together,
    so a swapped row serves with its own scale. A row-sharded table
    takes each row into its owner shard, under ``_mesh_dispatch_lock``."""
    if side not in ("user", "item"):
        raise ValueError(f"side must be 'user' or 'item', got {side!r}")
    name = "user_factors" if side == "user" else "item_factors"
    table = getattr(model, name)
    row_idx = np.asarray(row_idx, dtype=np.int64)
    rows = np.asarray(rows, dtype=np.float32)
    if len(row_idx) == 0:
        return model
    if isinstance(table, RowShardedTable):
        with _mesh_dispatch_lock:
            new = _write_sharded_rows(table, row_idx, rows)
    else:
        new = _write_table_rows(table, row_idx, rows)
    return dataclasses.replace(model, **{name: new})


#: cold-start growth floor: a side whose table has no free padding rows
#: grows by at least this many zero rows at once, so per-entity appends
#: do not re-allocate the table every time
COLD_START_GROW_MIN = 64


def _pow2_ceil(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _grow_rows(t: torch.Tensor, n: int, fill: float) -> torch.Tensor:
    return torch.cat([t, torch.full((n,) + tuple(t.shape[1:]), fill,
                                    dtype=t.dtype, device=t.device)])


def extend_factor_rows(model: ALSModel, side: str, new_keys, rows: np.ndarray
                       ) -> ALSModel:
    """Cold-start rows: register ``new_keys`` as new entities on
    ``side`` with the given factor rows. Padding rows past ``n_users`` /
    ``n_items`` are claimed first; only a full table grows, by
    pow2-rounded chunks of at least :data:`COLD_START_GROW_MIN` zero rows
    (scale 1 in a quantized table). Returns a new model: extended id
    map, raised count, rows written by :func:`apply_row_updates`."""
    from ..data.bimap import BiMap

    if side not in ("user", "item"):
        raise ValueError(f"side must be 'user' or 'item', got {side!r}")
    new_keys = list(new_keys)
    if not new_keys:
        return model
    name = "user_factors" if side == "user" else "item_factors"
    ids_name = "user_ids" if side == "user" else "item_ids"
    count_name = "n_users" if side == "user" else "n_items"
    table = getattr(model, name)
    ids = getattr(model, ids_name)
    n_real = getattr(model, count_name)
    rows = np.asarray(rows, dtype=np.float32)
    if rows.shape[0] != len(new_keys):
        raise ValueError(f"{len(new_keys)} keys but {rows.shape[0]} rows")
    for k in new_keys:
        if ids is not None and k in ids:
            raise ValueError(f"{side} {k!r} already indexed; fold in "
                             f"through apply_row_updates instead")
    n_after = n_real + len(new_keys)
    capacity = int(table.shape[0]) if isinstance(table, RowShardedTable) \
        else int(_table_leaves(table)[0].shape[0])
    if n_after > capacity:
        grow = _pow2_ceil(max(n_after - capacity, COLD_START_GROW_MIN))
        # a row-sharded table grows whole and splits again over its mesh
        # (to a shard multiple, as shard_model places it)
        mesh = table.mesh if isinstance(table, RowShardedTable) else None
        table = unshard_table(table)
        data, scale = _table_leaves(table)
        if isinstance(table, QuantizedFactors):
            table = QuantizedFactors(
                _grow_rows(data, grow, 0),
                None if scale is None else _grow_rows(scale, grow, 1.0),
                table.quant)
        else:
            table = _grow_rows(data, grow, 0)
        if mesh is not None:
            table = _shard_table(table, mesh)
    fwd = dict(ids.items()) if ids is not None else {}
    for i, k in enumerate(new_keys):
        fwd[k] = n_real + i
    model = dataclasses.replace(
        model, **{name: table, ids_name: BiMap(fwd), count_name: n_after})
    return apply_row_updates(
        model, side, np.arange(n_real, n_after, dtype=np.int64), rows)
