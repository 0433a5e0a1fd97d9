"""Fused gather + weighted Gramian: the training kernel and its plain
version (the port of ``predictionio_tpu/ops/fused_gram.py``).

``fused_gram(table, idx, wa, wb)`` returns ``(A [B, r, r] f32, b [B, r]
f32)`` with ``A[i] = sum_l wa[i, l] * f f^T`` and ``b[i] = sum_l
wb[i, l] * f`` over ``f = table[idx[i, l]]``. The table is f32 or the
bf16 shadow of one (upcast after the load); every sum is f32. Padding
slots carry w = 0 and any valid index.

The one switch is the device of the tensors: CPU tensors go to
:func:`fused_gram_reference`, CUDA tensors to the hand-written kernel in
``csrc/fused_gram.cu`` (built at first use), or the call raises. The
kernel takes rank up to :data:`FUSED_GRAM_MAX_RANK`; above it
``models/als.py`` resolves ``gram_mode="auto"`` to the einsum path and an
explicit ``"fused"`` raises, as the JAX package never resolves "auto" to
a kernel that cannot take the shape.

The kernel's grid is rows x L-splits. :func:`gram_plan` chooses, from the
shapes alone, into how many ranges a row's slots are cut (so that a few
long rows still fill the card) and whether rows are gathered by 16-byte
asynchronous copies; the wrapper allocates the scratch ``[B, splits, r*r
+ r]`` of partial sums that the kernel's second pass adds in the order of
the splits. :func:`split_gram_reference` is the plain version of that
cut and sum.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.device import H100_SMS, sm_count
from .launches import count_launch

#: largest rank the kernel's register tile holds (``csrc/gram_tile.cuh``
#: kMaxRank: 32 x 32 blocks of 4 x 4, a thread per lower-triangle block)
FUSED_GRAM_MAX_RANK = 128

#: history slots staged per pass (kChunk): a split is whole chunks
GRAM_CHUNK = 32

#: a split takes at least this many chunks, so that writing its partial A
#: stays small beside multiplying it
GRAM_MIN_CHUNKS = 8

#: most ranges a row is cut into, and the most bytes of partial sums
GRAM_MAX_SPLITS = 64
GRAM_SCRATCH_CAP = 32 << 20

#: blocks wanted for each SM before rows are left whole (several of the
#: kernel's 160-thread blocks fit an SM at rank 64)
GRAM_BLOCKS_PER_SM = 4

#: kernel launches since the last reset (counted by
#: ``launches.count_launch``; ``chip_smoke.py`` zeroes it before driving
#: the training path and reads it after)
LAUNCHES = 0

_ENTRY = {torch.float32: "fused_gram_f32", torch.bfloat16: "fused_gram_bf16"}

_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ._build import load_library

        lib = load_library("fused_gram")
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                           + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


class GramPlan(NamedTuple):
    """How one launch is cut (:func:`gram_plan`)."""
    splits: int         # ranges each row's slots are cut into
    vec16: bool         # rows gathered by 16-byte asynchronous copies
    scratch_bytes: int  # partial sums [B, splits, r*r + r] f32, 0 at 1

    @property
    def staging(self) -> str:
        return "cp.async-16B" if self.vec16 else "element-wise"


@functools.lru_cache(maxsize=4096)
def gram_plan(B: int, L: int, r: int, itemsize: int,
              n_sm: int = H100_SMS, aligned: bool = True) -> GramPlan:
    """The cut of one ``fused_gram`` launch, from its shapes: ``B`` rows
    of ``L`` slots over a table of rank ``r`` whose elements take
    ``itemsize`` bytes (4 f32, 2 bf16), on a card of ``n_sm`` SMs;
    ``aligned`` says the table starts on a 16-byte boundary.

    Rows stay whole where ``B`` alone gives every SM
    :data:`GRAM_BLOCKS_PER_SM` blocks. Fewer rows are cut into as many
    ranges as reach that, each at least :data:`GRAM_MIN_CHUNKS` chunks
    of :data:`GRAM_CHUNK` slots, at most :data:`GRAM_MAX_SPLITS` ranges
    and :data:`GRAM_SCRATCH_CAP` bytes of partial sums. Rows take
    16-byte copies only where a row is a multiple of 16 bytes and the
    table is aligned."""
    n_chunks = -(-L // GRAM_CHUNK)
    want = GRAM_BLOCKS_PER_SM * n_sm
    splits = 1
    if 0 < B < want:
        splits = max(1, min(-(-want // B), n_chunks // GRAM_MIN_CHUNKS,
                            GRAM_MAX_SPLITS,
                            GRAM_SCRATCH_CAP // (B * (r * r + r) * 4)))
    return GramPlan(splits, aligned and (r * itemsize) % 16 == 0,
                    B * splits * (r * r + r) * 4 if splits > 1 else 0)


def _check_args(table, idx, wa, wb):
    if table.dim() != 2:
        raise ValueError(f"table must be [m, r], got {tuple(table.shape)}")
    if idx.dim() != 2 or wa.shape != idx.shape or wb.shape != idx.shape:
        raise ValueError(f"idx, wa and wb must be one [B, L] shape, got "
                         f"{tuple(idx.shape)}, {tuple(wa.shape)} and "
                         f"{tuple(wb.shape)}")


def _check_cuda(table, idx, wa, wb):
    dev = table.device
    for name, t in (("idx", idx), ("wa", wa), ("wb", wb)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, table on {dev}")
    if table.dtype not in _ENTRY:
        raise TypeError(f"the kernel's table is f32 or bf16, got "
                        f"{table.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if wa.dtype != torch.float32 or wb.dtype != torch.float32:
        raise TypeError(f"weights must be f32, got {wa.dtype} and "
                        f"{wb.dtype}")
    r = table.shape[1]
    if not 1 <= r <= FUSED_GRAM_MAX_RANK:
        raise ValueError(f"the kernel takes rank 1..{FUSED_GRAM_MAX_RANK}, "
                         f"got {r}")
    for name, t in (("table", table), ("idx", idx), ("wa", wa), ("wb", wb)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if table.shape[0] < 1:
        raise ValueError("the table has no rows")
    if max(table.shape[0], idx.shape[0], idx.shape[1]) >= 2 ** 31:
        raise ValueError("a dimension past 2**31 is not supported")


def fused_gram(table: torch.Tensor, idx: torch.Tensor, wa: torch.Tensor,
               wb: torch.Tensor, plan_rows: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(A, b)`` of the fused gather and weighted Gramian (module
    docstring). CPU tensors run the plain version; CUDA tensors launch
    the kernel on the current stream and raise if it is refused.

    ``plan_rows`` cuts the launch as :func:`gram_plan` cuts one of that
    many rows (default: the launch's own): each row's slots are summed
    in the order a launch of ``plan_rows`` rows sums them, so a shard of
    a row block planned as the whole block gives its rows bit for bit.
    The plain version sums each row alike whatever the launch."""
    _check_args(table, idx, wa, wb)
    dev = table.device
    if dev.type == "cpu":
        return fused_gram_reference(table, idx, wa, wb)
    if dev.type != "cuda":
        raise ValueError(f"fused_gram runs on cuda or cpu, got {dev}")
    _check_cuda(table, idx, wa, wb)
    B, L = idx.shape
    r = table.shape[1]
    A = torch.empty((B, r, r), dtype=torch.float32, device=dev)
    b = torch.empty((B, r), dtype=torch.float32, device=dev)
    if B == 0:
        return A, b
    plan = gram_plan(plan_rows or B, L, r, table.element_size(),
                     sm_count(dev.index), table.data_ptr() % 16 == 0)
    scratch = None
    if plan.splits > 1:
        scratch = torch.empty((B, plan.splits, r * r + r),
                              dtype=torch.float32, device=dev)
    fn = getattr(_kernel_lib(), _ENTRY[table.dtype])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(dev.index, table.data_ptr(), idx.data_ptr(), wa.data_ptr(),
             wb.data_ptr(), B, L, table.shape[0], r, plan.splits,
             int(plan.vec16),
             None if scratch is None else scratch.data_ptr(), A.data_ptr(),
             b.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_gram kernel launch failed: CUDA error "
                           f"{err}")
    count_launch(__name__)
    return A, b


def fused_gram_reference(table: torch.Tensor, idx: torch.Tensor,
                         wa: torch.Tensor, wb: torch.Tensor,
                         plan_rows: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: gather, upcast, f32 contractions. It
    materializes the ``[B, L, r]`` gather that the kernel exists to
    avoid. It takes :func:`fused_gram`'s arguments so that it can stand
    in for it (a plain training run swaps it in); ``plan_rows`` cuts no
    launch here."""
    F = table[idx.long()].float()
    A = torch.einsum("blr,bls,bl->brs", F, F, wa.float())
    b = torch.einsum("blr,bl->br", F, wb.float())
    return A, b


def split_gram_reference(table: torch.Tensor, idx: torch.Tensor,
                         wa: torch.Tensor, wb: torch.Tensor, *, splits: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of a split launch: each row's slots cut into
    ``splits`` ranges of whole :data:`GRAM_CHUNK`-slot chunks exactly as
    the kernel cuts them, each range's ``(A, b)`` from
    :func:`fused_gram_reference`, added in the order of the ranges."""
    B, L = idx.shape
    r = table.shape[1]
    n_chunks = -(-L // GRAM_CHUNK)
    A = torch.zeros((B, r, r), dtype=torch.float32, device=table.device)
    b = torch.zeros((B, r), dtype=torch.float32, device=table.device)
    for s in range(splits):
        lo = (s * n_chunks // splits) * GRAM_CHUNK
        hi = min(((s + 1) * n_chunks // splits) * GRAM_CHUNK, L)
        As, bs = fused_gram_reference(table, idx[:, lo:hi], wa[:, lo:hi],
                                      wb[:, lo:hi])
        A += As
        b += bs
    return A, b
