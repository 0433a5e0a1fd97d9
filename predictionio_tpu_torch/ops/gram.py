"""Weighted Gramians of gathered factor rows (the port of
``predictionio_tpu/ops/gram.py``).

``gram_weighted`` and ``gram_dispatch``: ``A[..., :, :] = sum_l
w[..., l] * f_l f_l^T`` over ``F[..., L, r]``. These run outside any
kernel in the JAX package too, so they stay ``torch.einsum`` here. The
JAX package's "pair" mode packs two rank-r systems into one 128x128 MXU
tile; that is a TPU tiling with the same result, so in the port "pair" is
the same function as "einsum".

``gram_table(table, idx, wa, wb)`` is the port of ``gram_table_pallas``:
the ``(A, b)`` of ``ops/fused_gram.py`` computed from a fixed table held
on chip (in a block's shared memory when it fits, else gathered through
L2 by ``fused_gram``'s launch; ``csrc/gram_table.cu``). CPU tensors go
to :func:`gram_table_reference`, CUDA tensors to the kernel, or the call
raises. No path of the system calls it, in either package;
``chip_smoke.py`` and the tests hold it to its plain version. Left out: ``gram_table_supported`` (a probe of TPU
lowering; the kernel here builds with the other sources) and
``gram_pairs`` (the MXU pair tiling).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .fused_gram import _check_args, _check_cuda
from .launches import count_launch

GRAM_MODES = ("auto", "einsum", "pair", "fused")


def gram_weighted(F: torch.Tensor, w: torch.Tensor,
                  bf16: bool = False) -> torch.Tensor:
    """``A = sum_l w * f f^T`` with f32 accumulation. ``F`` may be the
    bf16 gather shadow (upcast exactly before the products). With
    ``bf16`` the operands ``F * w`` and ``F`` are rounded to bf16 first,
    as the JAX package feeds its bf16 einsum; their products are exact in
    f32 and the sum is f32."""
    F = F.float()
    w = w.float()
    if bf16:
        # ptpu: allow[dequant-outside-funnel] — a round trip through bf16
        # of the gathered [..., L, r] block (not a table), so the
        # operands carry the bf16 einsum's precision; the sum stays f32
        Fw = (F * w[..., None]).bfloat16().float()
        # ptpu: allow[dequant-outside-funnel] — the same round trip of F
        Fc = F.bfloat16().float()
        return torch.einsum("...lr,...ls->...rs", Fw, Fc)
    return torch.einsum("...lr,...ls,...l->...rs", F, F, w)


def gram_dispatch(F: torch.Tensor, w: torch.Tensor, mode: str,
                  bf16: bool = False) -> torch.Tensor:
    """``mode`` in :data:`GRAM_MODES`. With ``F`` already gathered every
    mode is the same weighted Gramian: "pair" is an MXU tiling and
    "fused" means the caller gathered first, so nothing is left to fuse
    (the fused entry is ``models/als.py::_lhs_fn``, before the gather)."""
    if mode not in GRAM_MODES:
        raise ValueError(f"gram mode must be one of {GRAM_MODES}, "
                         f"got {mode!r}")
    return gram_weighted(F, w, bf16=bf16)


#: kernel launches since the last reset (counted by
#: ``launches.count_launch``; ``chip_smoke.py`` zeroes it before driving a
#: path and reads it after)
LAUNCHES = 0
#: which branch the last launch took: 1 the table in shared memory, 2
#: rows gathered through L2
LAST_PATH = 0

_ENTRY = {torch.float32: "gram_table_f32", torch.bfloat16: "gram_table_bf16"}

_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ._build import load_library

        lib = load_library("gram_table")
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                           + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
                           + [ctypes.POINTER(ctypes.c_int)])
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def gram_table(table: torch.Tensor, idx: torch.Tensor, wa: torch.Tensor,
               wb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(A [B, r, r], b [B, r])`` f32 with ``A[i] = sum_l wa[i, l] f
    f^T`` and ``b[i] = sum_l wb[i, l] f`` over ``f = table[idx[i, l]]``.
    ``table`` [m, r] is f32 or bf16 (upcast after the load), ``idx``
    int32 and the weights f32, all [B, L]; padding slots carry w = 0.
    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream and raise if it is refused."""
    _check_args(table, idx, wa, wb)
    dev = table.device
    if dev.type == "cpu":
        return gram_table_reference(table, idx, wa, wb)
    if dev.type != "cuda":
        raise ValueError(f"gram_table runs on cuda or cpu, got {dev}")
    _check_cuda(table, idx, wa, wb)
    B, L = idx.shape
    r = table.shape[1]
    A = torch.empty((B, r, r), dtype=torch.float32, device=dev)
    b = torch.empty((B, r), dtype=torch.float32, device=dev)
    if B == 0:
        return A, b
    fn = getattr(_kernel_lib(), _ENTRY[table.dtype])
    stream = torch.cuda.current_stream(dev).cuda_stream
    path = ctypes.c_int(0)
    err = fn(dev.index, table.data_ptr(), idx.data_ptr(), wa.data_ptr(),
             wb.data_ptr(), B, L, table.shape[0], r, A.data_ptr(),
             b.data_ptr(), stream, ctypes.byref(path))
    if err != 0:
        raise RuntimeError(f"gram_table kernel launch failed: CUDA error "
                           f"{err}")
    count_launch(__name__, LAST_PATH=path.value)
    return A, b


def gram_table_reference(table: torch.Tensor, idx: torch.Tensor,
                         wa: torch.Tensor, wb: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: gather, upcast, f32 ``einsum`` (the oracle the
    JAX package's test holds ``gram_table_pallas`` to)."""
    F = table[idx.long()].float()
    A = torch.einsum("blr,bls,bl->brs", F, F, wa.float())
    b = torch.einsum("blr,bl->br", F, wb.float())
    return A, b
