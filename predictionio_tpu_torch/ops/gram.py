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
on chip (``csrc/gram_table.cu``): row workers of a few warps multiply on
the tensor cores at f32 accuracy, reading their rows from a copy of the
table in the block's shared memory when it fits (path 1), else gathering
them through L2 (path 2). :func:`table_plan` cuts the launch from the
shapes alone. CPU tensors go to :func:`gram_table_reference`, CUDA
tensors to the kernel, or the call raises. No path of the system calls
it, in either package; ``chip_smoke.py`` and the tests hold it to its
plain version. Left out: ``gram_table_supported`` (a probe of TPU
lowering; the kernel here builds with the other sources) and
``gram_pairs`` (the MXU pair tiling).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from ..utils.device import H100_SMS, sm_count
from .fused_gram import (
    GRAM_MAX_SPLITS,
    GRAM_MIN_CHUNKS,
    GRAM_SCRATCH_CAP,
    _check_args,
    _check_cuda,
)
from .launches import count_launch
from .smem import (
    SMEM_LIMIT,
    TABLE_GROUP,
    gram_resident_bytes,
    gram_table_bytes,
    table_worker_warps,
    table_workers,
)

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
#: which path the last launch took: 1 the table in shared memory, 2
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
                           + [ctypes.c_int] * 7 + [ctypes.c_longlong]
                           + [ctypes.c_void_p] * 4)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


class TablePlan(NamedTuple):
    """How one ``gram_table`` launch is cut (:func:`table_plan`)."""
    path: int           # 1 the table in shared memory, 2 through L2
    workers: int        # row workers a block
    warps: int          # warps a worker: one a pair of A's 16-row strips
    threads: int        # a block's threads
    blocks: int         # a persistent grid, at most one block an SM
    splits: int         # ranges each row's slots are cut into
    smem_bytes: int     # dynamic shared memory a block
    scratch_bytes: int  # partial sums [B, splits, r*r + r] f32, 0 at 1
    vec16: bool         # rows copied as 16-byte pieces


@functools.lru_cache(maxsize=4096)
def table_plan(m: int, r: int, itemsize: int, B: int, L: int,
               sms: int = H100_SMS, optin: int = SMEM_LIMIT,
               path: int = 0, aligned: bool = True) -> TablePlan:
    """The cut of one ``gram_table`` launch over an ``[m, r]`` table
    whose elements take ``itemsize`` bytes (4 f32, 2 bf16), for ``B``
    rows of ``L`` slots, on a card of ``sms`` SMs whose blocks may opt
    in to ``optin`` bytes of shared memory; ``aligned`` says the table
    starts on a 16-byte boundary.

    ``path`` 0 is the automatic choice: path 1 (the table and a zero
    row in each block's shared memory, at :func:`smem.table_row_words`
    a row) exactly where those bytes fit ``optin``, else path 2 (two
    buffers of :data:`smem.TABLE_GROUP` gathered rows a worker). 1 or 2
    forces a path; forcing path 1 where the table does not fit raises
    ValueError. A block holds :func:`smem.table_workers` workers of
    ``ceil(ceil(r / 16) / 2)`` warps; the grid is one block an SM or
    fewer. Rows stay whole where they give every worker of the grid an
    item; fewer rows are cut as ``fused_gram.gram_plan`` cuts them:
    ranges of at least :data:`GRAM_MIN_CHUNKS` groups of 32 slots, at
    most :data:`GRAM_MAX_SPLITS` ranges and :data:`GRAM_SCRATCH_CAP`
    bytes of partial sums."""
    if not 1 <= r <= 128:
        raise ValueError(f"the kernel takes rank 1..128, got {r}")
    if path not in (0, 1, 2):
        raise ValueError(f"path is 0 (automatic), 1 or 2, got {path}")
    fits = gram_resident_bytes(m, r, itemsize) <= optin
    if path == 1 and not fits:
        raise ValueError(f"a [{m}, {r}] table of {itemsize}-byte elements "
                         f"does not fit {optin} bytes of shared memory")
    if path == 0:
        path = 1 if fits else 2
    workers = table_workers(path, r, itemsize, optin)
    warps = table_worker_warps(-(-r // 16))
    groups = -(-L // TABLE_GROUP)
    want = sms * workers
    splits = 1
    if 0 < B < want:
        splits = max(1, min(-(-want // B), groups // GRAM_MIN_CHUNKS,
                            GRAM_MAX_SPLITS,
                            GRAM_SCRATCH_CAP // (B * (r * r + r) * 4)))
    items = B * splits
    return TablePlan(
        path, workers, warps, workers * warps * 32,
        max(1, min(sms, -(-items // workers))), splits,
        gram_table_bytes(path, m, r, itemsize, workers),
        B * splits * (r * r + r) * 4 if splits > 1 else 0,
        aligned and (r * itemsize) % 16 == 0)


@functools.lru_cache(maxsize=8)
def _optin(index: int) -> int:
    """The card's opt-in shared memory a block (the launch checks the
    plan against the runtime's own figure and refuses past it)."""
    props = torch.cuda.get_device_properties(index)
    return int(getattr(props, "shared_memory_per_block_optin", 0)
               or SMEM_LIMIT)


def gram_table(table: torch.Tensor, idx: torch.Tensor, wa: torch.Tensor,
               wb: torch.Tensor, path: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(A [B, r, r], b [B, r])`` f32 with ``A[i] = sum_l wa[i, l] f
    f^T`` and ``b[i] = sum_l wb[i, l] f`` over ``f = table[idx[i, l]]``.
    ``table`` [m, r] is f32 or bf16 (upcast after the load), ``idx``
    int32 and the weights f32, all [B, L]; padding slots carry w = 0.
    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream, cut by :func:`table_plan` (``path`` 0 lets it
    choose, 1 or 2 forces one), and raise if it is refused."""
    _check_args(table, idx, wa, wb)
    dev = table.device
    if dev.type == "cpu":
        return gram_table_reference(table, idx, wa, wb)
    if dev.type != "cuda":
        raise ValueError(f"gram_table runs on cuda or cpu, got {dev}")
    _check_cuda(table, idx, wa, wb)
    B, L = idx.shape
    m, r = table.shape
    A = torch.empty((B, r, r), dtype=torch.float32, device=dev)
    b = torch.empty((B, r), dtype=torch.float32, device=dev)
    if B == 0:
        return A, b
    plan = table_plan(m, r, table.element_size(), B, L,
                      sm_count(dev.index), _optin(dev.index), path,
                      table.data_ptr() % 16 == 0)
    scratch = (torch.empty(plan.scratch_bytes // 4, dtype=torch.float32,
                           device=dev) if plan.splits > 1 else None)
    fn = getattr(_kernel_lib(), _ENTRY[table.dtype])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(dev.index, table.data_ptr(), idx.data_ptr(), wa.data_ptr(),
             wb.data_ptr(), B, L, m, r, plan.path, plan.workers,
             plan.splits, plan.smem_bytes,
             None if scratch is None else scratch.data_ptr(),
             A.data_ptr(), b.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gram_table kernel launch failed: CUDA error "
                           f"{err}")
    count_launch(__name__, LAST_PATH=plan.path)
    return A, b


def gram_table_reference(table: torch.Tensor, idx: torch.Tensor,
                         wa: torch.Tensor, wb: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: gather, upcast, f32 ``einsum`` (the oracle the
    JAX package's test holds ``gram_table_pallas`` to); an index outside
    ``[0, m)`` gathers a zero row, as the kernel's do."""
    m = table.shape[0]
    inside = (idx >= 0) & (idx < m)
    F = torch.where(inside[..., None], table[idx.long().clamp(0, m - 1)],
                    torch.zeros((), dtype=table.dtype, device=table.device)
                    ).float()
    A = torch.einsum("blr,bls,bl->brs", F, F, wa.float())
    b = torch.einsum("blr,bl->br", F, wb.float())
    return A, b
