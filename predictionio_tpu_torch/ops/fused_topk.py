"""Fused gather -> score -> top-k: the serving kernel and its plain version.

``fused_topk`` returns ``(scores [B, k] f32, ids [B, k] int32)`` with
``scores[b] = top_k((user_table[idx[b]] * user_scale) @ (item_table *
item_scale).T)``: ids are offset by ``base``, items whose id is at or
past ``n_items`` score -inf, ties go to the lower id, and slots past the
catalog hold ``(-inf, 0)``. Tables are f32, bf16, or int8 with per-row
f32 scales (both or neither); every product accumulates in f32.

The one switch is the device of the tensors: CPU tensors go to
:func:`fused_topk_reference`, CUDA tensors to the hand-written kernel in
``csrc/fused_topk.cu`` (built at first use), or the call raises.

The kernel's grid is query blocks x catalogue splits. :func:`topk_plan`
chooses, from the shapes alone, how many queries a block takes, how many
item rows a staged tile holds, into how many ranges the catalogue is
split (so that a small batch still fills the card) and whether the tiles
are staged by 16-byte asynchronous copies; the wrapper allocates the
scratch ``[B, splits, kp]`` of partial lists that the kernel's second
pass merges. :func:`merge_partial_topk` is that pass's plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.device import H100_SMS, sm_count
from .launches import count_launch

#: largest k the kernel's running top-k list holds (``csrc/fused_topk.cu``
#: kMaxK); larger k goes to ``models/als.py::_serve_topk``
TOPK_MAX_K = 128

#: largest rank the kernel's shared-memory tile takes (kMaxRank)
TOPK_MAX_RANK = 256

#: queries a block takes at most, item rows a staged tile holds at most
#: and at least (kMaxQB, kMaxChunk, kMinChunk)
TOPK_MAX_QB = 64
TOPK_MAX_CHUNK = 128
TOPK_MIN_CHUNK = 32

#: dynamic shared memory a block may ask for on Hopper (227 KB)
SMEM_LIMIT = 232_448

#: shared memory of one SM (228 KB); each resident block also takes 1 KB
SM_SMEM = 233_472

#: most catalogue ranges a launch splits into, and the most bytes of
#: partial lists (scores and ids) the scratch may take
TOPK_MAX_SPLITS = 512
TOPK_SCRATCH_CAP = 32 << 20

#: id of an empty slot in a partial list (kEmptyId): loses every tie
EMPTY_ID = 0x7FFFFFFF

#: wrapper calls that launched the kernel since the last reset, one a call
#: whatever the number of passes (counted by ``launches.count_launch``;
#: ``chip_smoke.py`` zeroes it before driving the serving path and reads
#: it after)
LAUNCHES = 0

_ENTRY = {torch.float32: "fused_topk_f32",
          torch.bfloat16: "fused_topk_bf16",
          torch.int8: "fused_topk_i8"}

_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ._build import load_library

        lib = load_library("fused_topk")
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                           + [ctypes.c_int] * 11
                           + [ctypes.c_void_p] * 5)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


class TopkPlan(NamedTuple):
    """How one launch is cut (:func:`topk_plan`)."""
    qb: int             # queries a block takes (a multiple of 8)
    chunk: int          # item rows a staged tile holds
    splits: int         # ranges the catalogue is split into
    vec16: bool         # tiles staged by 16-byte asynchronous copies
    kp: int             # k rounded up to a power of two
    smem_bytes: int     # dynamic shared memory a block asks for
    scratch_bytes: int  # partial lists [B, splits, kp], 0 at one split

    @property
    def staging(self) -> str:
        return "cp.async-16B" if self.vec16 else "element-wise"


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def topk_smem_bytes(row_bytes: int, qb: int, chunk: int, k: int) -> int:
    """Dynamic shared memory of one block (``csrc/fused_topk.cu``
    smem_bytes): two item tiles and the user rows at a stride of the row
    padded to 32 bytes plus 16, per-query scales, thresholds and counts,
    the running lists (32 entries for k <= 32, else 128) and the
    candidate lists."""
    sw = _ceil_div(row_bytes, 32) * 8 + 4
    words = (2 * chunk * sw + qb * sw + 4 * qb
             + 2 * qb * (32 if k <= 32 else 128) + 2 * qb * chunk)
    return 4 * words


@functools.lru_cache(maxsize=4096)
def topk_plan(B: int, n_rows: int, r: int, itemsize: int, k: int,
              n_sm: int = H100_SMS, aligned: bool = True) -> TopkPlan:
    """The cut of one ``fused_topk`` launch, from its shapes: ``B``
    queries against ``n_rows`` item rows of rank ``r`` whose elements take
    ``itemsize`` bytes (4 f32, 2 bf16, 1 int8), on a card of ``n_sm`` SMs;
    ``aligned`` says the item table starts on a 16-byte boundary.

    A block takes up to 64 queries and 128-row tiles, fewer where the
    rank or k would pass the shared-memory limit. The card holds one
    wave of ``n_sm`` blocks, or twice that where two blocks' shared
    memory fits an SM. Where the query blocks alone are fewer than the
    SMs, the catalogue is split into as many ranges as keep the grid
    within that one wave: at most one range an SM (the second pass
    merges a query's ranges in one block), one range a tile,
    :data:`TOPK_MAX_SPLITS` ranges and :data:`TOPK_SCRATCH_CAP` bytes of
    partial lists. Tiles take 16-byte copies only where every row is a
    multiple of 16 bytes and the table is aligned."""
    row_bytes = r * itemsize
    kp = 1 << (k - 1).bit_length()
    qb = min(TOPK_MAX_QB, 8 * _ceil_div(max(B, 1), 8))
    chunk = TOPK_MAX_CHUNK
    while topk_smem_bytes(row_bytes, qb, chunk, k) > SMEM_LIMIT:
        if chunk > TOPK_MIN_CHUNK:
            chunk //= 2
        elif qb > 8:
            qb = 8 * _ceil_div(qb // 2, 8)
        else:
            raise ValueError(f"rank {r} at {itemsize} bytes and k {k} do "
                             f"not fit a block's shared memory")
    n_qblocks = _ceil_div(max(B, 1), qb)
    n_chunks = _ceil_div(n_rows, chunk)
    smem = topk_smem_bytes(row_bytes, qb, chunk, k)
    wave = n_sm * (2 if 2 * (smem + 1024) <= SM_SMEM else 1)
    splits = 1
    if n_qblocks < n_sm:
        splits = max(1, min(wave // n_qblocks, n_sm, n_chunks,
                            TOPK_MAX_SPLITS,
                            TOPK_SCRATCH_CAP // (max(B, 1) * kp * 8)))
    return TopkPlan(qb, chunk, splits, aligned and row_bytes % 16 == 0, kp,
                    smem, B * splits * kp * 8 if splits > 1 else 0)


def _check_args(user_table, idx, item_table, user_scale, item_scale, k):
    if (user_scale is None) != (item_scale is None):
        raise ValueError("int8 tables quantize both sides: pass both "
                         "scales or neither")
    if not 1 <= k <= TOPK_MAX_K:
        raise ValueError(f"fused_topk takes 1 <= k <= {TOPK_MAX_K}, "
                         f"got {k}")
    if user_table.dim() != 2 or item_table.dim() != 2 \
            or user_table.shape[1] != item_table.shape[1]:
        raise ValueError(f"tables must be [m, r] and [I, r], got "
                         f"{tuple(user_table.shape)} and "
                         f"{tuple(item_table.shape)}")
    if idx.dim() != 1:
        raise ValueError(f"idx must be 1-D, got shape {tuple(idx.shape)}")
    if item_table.shape[0] < 1:
        raise ValueError("the item table has no rows")


def _check_cuda(user_table, idx, item_table, user_scale, item_scale):
    dev = user_table.device
    named = {"idx": idx, "item_table": item_table,
             "user_scale": user_scale, "item_scale": item_scale}
    for name, t in named.items():
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, user_table on {dev}")
    if user_table.dtype not in _ENTRY or item_table.dtype != user_table.dtype:
        raise TypeError(f"kernel tables are f32, bf16 or int8 of one dtype, "
                        f"got {user_table.dtype} and {item_table.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    r = user_table.shape[1]
    if not 1 <= r <= TOPK_MAX_RANK:
        raise ValueError(f"the kernel takes rank 1..{TOPK_MAX_RANK}, got {r}")
    for name, t in (("user_table", user_table), ("idx", idx),
                    ("item_table", item_table)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t, rows in (("user_scale", user_scale, user_table.shape[0]),
                          ("item_scale", item_scale, item_table.shape[0])):
        if t is None:
            continue
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.numel() != rows:
            raise ValueError(f"{name} must be contiguous f32 with one "
                             f"value per table row ({rows})")
    if max(user_table.numel(), item_table.numel()) >= 2 ** 31 \
            or idx.numel() >= 2 ** 31:
        raise ValueError("tables past 2**31 elements are not supported")


def fused_topk(user_table: torch.Tensor, idx: torch.Tensor,
               item_table: torch.Tensor,
               user_scale: Optional[torch.Tensor] = None,
               item_scale: Optional[torch.Tensor] = None,
               base: Optional[int] = None, *, k: int, n_items: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of the fused gather and score (module docstring). CPU
    tensors run the plain version; CUDA tensors launch the kernel on the
    current stream and raise if it is refused."""
    _check_args(user_table, idx, item_table, user_scale, item_scale, k)
    dev = user_table.device
    if dev.type == "cpu":
        return fused_topk_reference(user_table, idx, item_table, user_scale,
                                    item_scale, base, k=k, n_items=n_items)
    if dev.type != "cuda":
        raise ValueError(f"fused_topk runs on cuda or cpu, got {dev}")
    _check_cuda(user_table, idx, item_table, user_scale, item_scale)
    B = idx.shape[0]
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return out_s, out_i
    plan = topk_plan(B, item_table.shape[0], user_table.shape[1],
                     item_table.element_size(), k,
                     sm_count(dev.index),
                     item_table.data_ptr() % 16 == 0)
    part_s = part_i = None
    if plan.splits > 1:  # one allocation: scores, then ids
        part = torch.empty((2, B, plan.splits, plan.kp), dtype=torch.int32,
                           device=dev)
        part_s, part_i = part[0], part[1]
    fn = getattr(_kernel_lib(), _ENTRY[user_table.dtype])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(dev.index, user_table.data_ptr(), idx.data_ptr(),
             item_table.data_ptr(),
             None if user_scale is None else user_scale.data_ptr(),
             None if item_scale is None else item_scale.data_ptr(),
             B, user_table.shape[0], item_table.shape[0],
             user_table.shape[1], k, int(base or 0), int(n_items),
             plan.qb, plan.chunk, plan.splits, int(plan.vec16),
             None if part_s is None else part_s.data_ptr(),
             None if part_i is None else part_i.data_ptr(),
             out_s.data_ptr(), out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_topk kernel launch failed: CUDA error "
                           f"{err}")
    count_launch(__name__)
    return out_s, out_i


def fused_topk_reference(user_table: torch.Tensor, idx: torch.Tensor,
                         item_table: torch.Tensor,
                         user_scale: Optional[torch.Tensor] = None,
                         item_scale: Optional[torch.Tensor] = None,
                         base: Optional[int] = None, *, k: int, n_items: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: gather, upcast, scale, the full ``[B, I]`` score
    matrix, mask, and a stable descending sort (ties keep the lower id,
    which ``torch.topk`` does not promise). Past the catalog it pads to
    ``[B, k]`` with ``(-inf, 0)``."""
    rows = idx.long()
    vecs = user_table[rows].float()
    if user_scale is not None:
        vecs = vecs * user_scale.reshape(-1)[rows][:, None]
    scores = vecs @ item_table.float().T
    if item_scale is not None:
        scores = scores * item_scale.reshape(1, -1)
    n_rows = item_table.shape[0]
    gid = torch.arange(n_rows, dtype=torch.int32, device=scores.device) \
        + int(base or 0)
    scores = torch.where((gid < n_items)[None, :], scores,
                         torch.tensor(float("-inf"), device=scores.device))
    kk = min(k, n_rows)
    s, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    s, ids = s[:, :kk], gid[pos[:, :kk]]
    if k > kk:
        s = torch.nn.functional.pad(s, (0, k - kk), value=float("-inf"))
        ids = torch.nn.functional.pad(ids, (0, k - kk), value=0)
    return s.contiguous(), ids.contiguous()


def merge_partial_topk(part_s: torch.Tensor, part_i: torch.Tensor, *,
                       k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the kernel's second pass: ``part_s`` /
    ``part_i`` ``[B, splits, kp]`` hold each catalogue range's best list
    (empty slots ``(-inf, EMPTY_ID)``); the result is the k best of all
    of them by (score descending, id ascending), empty slots turned into
    ``(-inf, 0)``. The order is total, so the result is what one pass
    over the whole catalogue gives."""
    B = part_s.shape[0]
    s = part_s.reshape(B, -1)
    i = part_i.reshape(B, -1)
    by_id = torch.argsort(i, dim=1, stable=True)
    s, i = s.gather(1, by_id), i.gather(1, by_id)
    by_score = torch.argsort(s, dim=1, descending=True, stable=True)
    s, i = s.gather(1, by_score)[:, :k], i.gather(1, by_score)[:, :k]
    empty = i == EMPTY_ID
    s = torch.where(empty, torch.full_like(s, float("-inf")), s)
    i = torch.where(empty, torch.zeros_like(i), i)
    if s.shape[1] < k:
        pad = k - s.shape[1]
        s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
        i = torch.nn.functional.pad(i, (0, pad), value=0)
    return s.contiguous(), i.contiguous()
