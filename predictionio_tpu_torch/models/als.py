"""ALS serving on the card: the serving half of ``predictionio_tpu/models/als.py``.

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

Training, fold-in, sharded and replicated placement and pinned rows are
not in this module yet.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.fused_topk import TOPK_MAX_K, fused_topk, fused_topk_reference
from ..utils.device import DeviceLike, resolve_device

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


def _table_leaves(t: Table) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(data, scale-or-None) of a factor table, quantized or plain."""
    if isinstance(t, QuantizedFactors):
        return t.data, t.scale
    return t, None


def table_quant(t: Table) -> str:
    """The quant dtype of a factor table ("off" for plain f32)."""
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
    """Host f32 copy of a factor table (plain or quantized, card or host
    resident) — the parity-probe view."""
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
    return dataclasses.replace(model, user_factors=qU, item_factors=qV)


def place_model(model: ALSModel, device: DeviceLike = None) -> ALSModel:
    """The model with both tables on ``device`` (the card by default),
    moved once at deploy so no query re-transfers them."""
    dev = resolve_device(device)
    return dataclasses.replace(model,
                               user_factors=model.user_factors.to(dev),
                               item_factors=model.item_factors.to(dev))


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
    idx_t = torch.from_numpy(np.asarray(idx, dtype=np.int32)).to(ud.device)
    if 1 <= k_dev <= TOPK_MAX_K:
        return fused_topk(ud, idx_t, vd, us, vs, k=k_dev, n_items=n_items)
    return _serve_topk(user_table, item_table, idx_t, k=k_dev,
                       n_items=n_items)


def recommend_products(model: ALSModel, user_index: int, k: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k (item_index, score) for one user. Asking for more than the
    catalog returns the whole catalog ranked, never padded rows."""
    ids, scores = recommend_batch(model, np.asarray([user_index]), k)
    return ids[0], scores[0]


#: top-k rows per dispatch: bounds the plain path's [chunk, n_items]
#: score matrix for large eval sweeps
_TOPK_CHUNK = 2048


def _dispatch_topk_chunk(model: ALSModel, user_indices: np.ndarray, k: int
                         ) -> Callable[[], Tuple[np.ndarray, np.ndarray]]:
    """Launch ONE top-k dispatch (batch <= ``_TOPK_CHUNK``) and return a
    resolver that waits for it and hands back host ``([B, k] ids,
    scores)``. On the card the resolver waits on a CUDA event recorded
    right after the launch, so the caller may launch more work first."""
    kk = min(k, model.n_items)
    k_dev = _compiled_k(k, model.n_items)
    scores, ids = _device_topk(model.user_factors, model.item_factors,
                               user_indices, k_dev, model.n_items)
    done = None
    if scores.is_cuda:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(scores.device))

    def resolve() -> Tuple[np.ndarray, np.ndarray]:
        if done is not None:
            done.synchronize()
        return (ids[:, :kk].cpu().numpy().astype(np.int64),
                scores[:, :kk].cpu().numpy())

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
        _dispatch_topk_chunk(model, user_indices[s:s + _TOPK_CHUNK], k)
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


def _host_row_f32(t: Table, i: int) -> np.ndarray:
    """One factor row as host f32, dequantizing if needed."""
    data, scale = _table_leaves(t)
    row = data[i].float().cpu().numpy()
    if scale is not None:
        row = row * float(scale[i].reshape(()).item())
    return row


def predict_rating(model: ALSModel, user_index: int, item_index: int
                   ) -> float:
    u = _host_row_f32(model.user_factors, user_index)
    v = _host_row_f32(model.item_factors, item_index)
    return float(u @ v)
