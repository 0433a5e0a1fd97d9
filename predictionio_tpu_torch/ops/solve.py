"""Batched small SPD solves for the ALS half-steps (the port of
``predictionio_tpu/ops/solve.py``).

``solve_spd_batch(A, b, jitter)`` solves ``(A[i] + jitter * I) x = b[i]``
for ``A [..., r, r]``, ``b [..., r]``. :func:`solve_route` picks the
route from the dtype, the rank and the device type alone, as the JAX
package routes by dtype and rank (``solve.py:277``: non-f32 input and
padded rank past 128 go to XLA):

- CPU tensors: :func:`solve_spd_reference`, the plain column loop
  ("plain");
- CUDA f32 tensors with ``r <= 128``: the hand-written kernel in
  ``csrc/chol_solve.cu`` (built at first use), or the call raises
  ("kernel");
- CUDA tensors that are not f32, or have ``r > 128``:
  ``torch.linalg.cholesky_ex`` and ``torch.cholesky_solve`` ("library"),
  where the JAX package takes XLA's ``cho_factor`` / ``cho_solve``. No
  TPU kernel takes these systems, so this route stands in for none.

The plain version does what the TPU kernel's ``_chol_body`` does,
including both clamps (``rsqrt(max(piv, 1e-30))`` on the pivot,
``max(l_kk, 1e-30)`` in each division); it is not
``torch.linalg.cholesky``. Both read only the lower triangle of ``A``.

The kernel keeps each system's chain of column steps inside one warp.
:func:`solve_plan` chooses, from the rank and the count alone, the padded
rank, whether the rows live in registers (rank <= 64) or in shared
memory, how many systems a warp and warps a block take, and the shared
memory a block needs; :func:`lane_rows` is which rows each lane of a
system owns, the map the kernel hard-codes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from ..utils.device import H100_SMS, sm_count
from .launches import count_launch
# the launch's bounds live with the shared-memory formula: the largest
# rank the kernel takes (``csrc/chol_solve.cu`` kMaxRank), the largest
# whose rows live in registers (kRegMaxRank; past it the matrix sits in
# shared memory), the columns of a chunk of a row, one phase of the
# factorization (kChunk), and the most warps a block takes
# (kWarpsPerBlock)
from .smem import (
    CHOL_CHUNK,
    CHOL_MAX_RANK,
    CHOL_REG_MAX_RANK,
    CHOL_WARPS_PER_BLOCK,
    chol_padded_rank,
    chol_smem_bytes,
    chol_systems_per_warp,
)

#: kernel launches since the last reset (counted by
#: ``launches.count_launch``; ``chip_smoke.py`` zeroes it before driving
#: the training path and reads it after)
LAUNCHES = 0

_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ._build import load_library

        lib = load_library("chol_solve")
        lib.chol_solve_f32.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                                       + [ctypes.c_int] * 5
                                       + [ctypes.c_longlong, ctypes.c_float,
                                          ctypes.c_void_p])
        lib.chol_solve_f32.restype = ctypes.c_int
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def lane_rows(R: int) -> Tuple[Tuple[int, ...], ...]:
    """The rows each lane of a system owns at padded rank ``R``, by lane.
    Rows pair from both ends of the matrix (``t`` with ``R-1-t``), so a
    lane's rows are about ``R+1`` entries long together and every lane
    updates one row more than another at most in any column step. Up to
    rank 64, ``R/2`` lanes own a pair each; past it, 32 lanes own
    ``R/32`` rows: ``t, R-1-t, 32+t, R-33-t`` (``csrc/chol_solve.cu``
    ``slot_row``)."""
    if R <= CHOL_REG_MAX_RANK:
        return tuple((t, R - 1 - t) for t in range(R // 2))
    slots = (lambda t: t, lambda t: R - 1 - t, lambda t: 32 + t,
             lambda t: R - 33 - t)[:R // 32]
    return tuple(tuple(f(t) for f in slots) for t in range(32))


class SolvePlan(NamedTuple):
    """How one launch is cut (:func:`solve_plan`)."""
    rank: int              # padded rank R
    route: str             # "registers" (R <= 64) or "shared"
    lanes: int             # lanes that own rows of a system
    systems_per_warp: int
    warps_per_block: int
    blocks: int
    smem_bytes: int        # dynamic shared memory a block
    vec16: bool            # rows loaded as 16-byte words


@functools.lru_cache(maxsize=4096)
def solve_plan(r: int, n: int, n_sm: int = H100_SMS,
               aligned: bool = True) -> SolvePlan:
    """The cut of one ``chol_solve`` launch of ``n`` systems of rank
    ``r`` on a card of ``n_sm`` SMs; ``aligned`` says ``A`` starts on a
    16-byte boundary.

    Rows in registers take ``R/2`` lanes a system, so a warp holds
    ``32 / pow2(R/2)`` systems, and up to :data:`CHOL_WARPS_PER_BLOCK`
    warps a block: fewer where the systems would not give every SM a
    block. Each system keeps two multiplier vectors of ``R + CHOL_CHUNK``
    floats and, for the backward sweep, the rows of L (row ``i`` rounded
    up to whole 16-byte words) in shared memory. Past rank 64 a system's
    matrix takes ``R x (R+4)`` floats of shared memory and two multiplier
    vectors of ``R``: one warp a block. Rows load as 16-byte words where
    every row starts on 16 bytes."""
    R = chol_padded_rank(r)
    lanes = len(lane_rows(R))
    per_warp = chol_systems_per_warp(R)
    if R <= CHOL_REG_MAX_RANK:
        route = "registers"
        warps = -(-n // per_warp)
        wpb = max(1, min(CHOL_WARPS_PER_BLOCK, warps // n_sm))
    else:
        route = "shared"
        wpb = 1
    return SolvePlan(R, route, lanes, per_warp, wpb,
                     -(-n // (per_warp * wpb)), chol_smem_bytes(R, wpb),
                     aligned and r % 4 == 0)


def _check_args(A, b):
    if A.dim() < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"A must be [..., r, r], got {tuple(A.shape)}")
    if tuple(b.shape) != tuple(A.shape[:-1]):
        raise ValueError(f"b must be {tuple(A.shape[:-1])}, got "
                         f"{tuple(b.shape)}")
    if b.device != A.device:
        raise ValueError(f"b is on {b.device}, A on {A.device}")


def kernel_takes(A: torch.Tensor) -> bool:
    """Whether a CUDA ``A`` goes to the kernel: f32 at rank <= 128 (the
    JAX package routes everything else to XLA)."""
    return A.dtype == torch.float32 and A.shape[-1] <= CHOL_MAX_RANK


def solve_route(dtype: torch.dtype, rank: int, device_type: str) -> str:
    """Where :func:`solve_spd_batch` sends systems of ``dtype`` and
    ``rank`` on a device of ``device_type``: "plain" on the CPU,
    "kernel" for CUDA f32 up to :data:`CHOL_MAX_RANK`, "library" for
    every other CUDA system."""
    if device_type == "cpu":
        return "plain"
    if device_type != "cuda":
        raise ValueError(f"solve_spd_batch runs on cuda or cpu, got "
                         f"{device_type}")
    if dtype == torch.float32 and rank <= CHOL_MAX_RANK:
        return "kernel"
    return "library"


def solve_spd_batch(A: torch.Tensor, b: torch.Tensor,
                    jitter: float = 1e-6) -> torch.Tensor:
    """``x`` with ``(A[i] + jitter * I) x[i] = b[i]`` (module docstring
    for the routes). ``A`` is not modified."""
    _check_args(A, b)
    dev = A.device
    route = solve_route(A.dtype, A.shape[-1], dev.type)
    if route == "plain":
        return solve_spd_reference(A, b, jitter)
    if route == "library":
        return solve_spd_library(A, b, jitter)
    if b.dtype != torch.float32:
        raise TypeError(f"b must be f32 with an f32 A, got {b.dtype}")
    r = A.shape[-1]
    lead = A.shape[:-2]
    A2 = A.reshape(-1, r, r).contiguous()
    b2 = b.reshape(-1, r).contiguous()
    n = A2.shape[0]
    if n >= 2 ** 31:
        raise ValueError("more than 2**31 systems in one call")
    x = torch.empty((n, r), dtype=torch.float32, device=dev)
    if n == 0:
        return x.reshape(*lead, r)
    plan = solve_plan(r, n, sm_count(dev.index), A2.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel_lib().chol_solve_f32(dev.index, A2.data_ptr(),
                                       b2.data_ptr(), x.data_ptr(), n, r,
                                       plan.rank, plan.warps_per_block,
                                       int(plan.vec16), plan.smem_bytes,
                                       float(jitter), stream)
    if err != 0:
        raise RuntimeError(f"chol_solve kernel launch failed: CUDA error "
                           f"{err}")
    count_launch(__name__)
    return x.reshape(*lead, r)


def solve_spd_library(A: torch.Tensor, b: torch.Tensor,
                      jitter: float = 1e-6) -> torch.Tensor:
    """The "library" route: ``torch.linalg.cholesky_ex`` of ``A +
    jitter * I`` (the lower triangle only, as the kernel reads it) and
    ``torch.cholesky_solve``, unclamped like XLA's ``cho_factor``.
    Computes in f32, or f64 for f64 input, and returns ``b``'s dtype."""
    r = A.shape[-1]
    dt = torch.promote_types(A.dtype, torch.float32)
    M = A.to(dt) + jitter * torch.eye(r, dtype=dt, device=A.device)
    L, _ = torch.linalg.cholesky_ex(M)
    x = torch.cholesky_solve(b.to(dt)[..., None], L)[..., 0]
    return x.to(b.dtype)


def solve_spd_reference(A: torch.Tensor, b: torch.Tensor,
                        jitter: float = 1e-6) -> torch.Tensor:
    """The plain version, batched over every leading axis: the TPU
    kernel's in-place right-looking Cholesky (pivot clamped before the
    rsqrt), right-looking forward substitution and left-looking backward
    substitution, each division clamped. Only the lower triangle of
    ``A`` reaches ``x``: an entry above the diagonal is only ever
    multiplied by an exact zero, so any finite values there leave ``x``
    as it is. Computes in f32 (the kernel's
    scratch type), or f64 for f64 input, and returns ``b``'s dtype."""
    r = A.shape[-1]
    lead = A.shape[:-2]
    dt = torch.promote_types(A.dtype, torch.float32)
    eye = torch.eye(r, dtype=dt, device=A.device)
    M = (A.to(dt) + jitter * eye).reshape(-1, r, r)
    acc = b.reshape(-1, r).to(dt)
    rows = torch.arange(r, device=A.device)
    for k in range(r):
        colk = M[:, :, k]
        inv_sqrt = torch.rsqrt(torch.clamp(colk[:, k:k + 1], min=1e-30))
        lk = colk * inv_sqrt * (rows >= k)
        M -= lk[:, :, None] * lk[:, None, :]
        M[:, :, k] = lk
    for k in range(r):
        Lk = M[:, :, k]
        yk = acc[:, k:k + 1] / torch.clamp(Lk[:, k:k + 1], min=1e-30)
        acc = torch.where(rows == k, yk, acc - Lk * yk * (rows > k))
    for k in range(r - 1, -1, -1):
        Lk = M[:, :, k]
        s = torch.sum(Lk * acc * (rows > k), dim=1, keepdim=True)
        xk = (acc[:, k:k + 1] - s) / torch.clamp(Lk[:, k:k + 1], min=1e-30)
        acc = torch.where(rows == k, xk, acc)
    return acc.reshape(*lead, r).to(b.dtype)


def gramian(factors: torch.Tensor) -> torch.Tensor:
    """``F^T F`` in f32: the rank x rank Gramian every row of the
    implicit half-step shares (a plain matrix product, as the JAX package
    leaves it to XLA)."""
    f32 = factors.float()
    return f32.T @ f32
