"""Batched small SPD solves for the ALS half-steps (the port of
``predictionio_tpu/ops/solve.py``).

``solve_spd_batch(A, b, jitter)`` solves ``(A[i] + jitter * I) x = b[i]``
for ``A [..., r, r]``, ``b [..., r]``. The one switch is the device of
the tensors, plus the JAX package's own route by dtype and rank
(``solve.py:277``: non-f32 input and padded rank past 128 go to XLA):

- CPU tensors: :func:`solve_spd_reference`, the plain column loop;
- CUDA f32 tensors with ``r <= 128``: the hand-written kernel in
  ``csrc/chol_solve.cu`` (built at first use), or the call raises;
- CUDA tensors that are not f32, or have ``r > 128``: the plain column
  loop on the card, where the JAX package takes XLA's ``cho_factor``.

The plain version does what the TPU kernel's ``_chol_body`` does,
including both clamps (``rsqrt(max(piv, 1e-30))`` on the pivot,
``max(l_kk, 1e-30)`` in each division); it is not
``torch.linalg.cholesky``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

#: largest rank the kernel takes: its matrix sits in shared memory
#: (``csrc/chol_solve.cu`` kMaxRank, 66 KB at r = 128)
CHOL_MAX_RANK = 128

#: kernel launches since the last reset (a plain count; ``chip_smoke.py``
#: zeroes it before driving the training path and reads it after)
LAUNCHES = 0
_launch_lock = threading.Lock()

_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ._build import load_library

        lib = load_library("chol_solve")
        lib.chol_solve_f32.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                                       + [ctypes.c_int] * 2
                                       + [ctypes.c_float, ctypes.c_void_p])
        lib.chol_solve_f32.restype = ctypes.c_int
        _lib = lib
    return _lib


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


def solve_spd_batch(A: torch.Tensor, b: torch.Tensor,
                    jitter: float = 1e-6) -> torch.Tensor:
    """``x`` with ``(A[i] + jitter * I) x[i] = b[i]`` (module docstring
    for the routes). ``A`` is not modified."""
    global LAUNCHES
    _check_args(A, b)
    dev = A.device
    if dev.type == "cpu":
        return solve_spd_reference(A, b, jitter)
    if dev.type != "cuda":
        raise ValueError(f"solve_spd_batch runs on cuda or cpu, got {dev}")
    if not kernel_takes(A):
        # the JAX package's XLA route (solve.py:277), taken by dtype and
        # rank only
        return solve_spd_reference(A, b, jitter)
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel_lib().chol_solve_f32(dev.index, A2.data_ptr(),
                                       b2.data_ptr(), x.data_ptr(), n, r,
                                       float(jitter), stream)
    if err != 0:
        raise RuntimeError(f"chol_solve kernel launch failed: CUDA error "
                           f"{err}")
    with _launch_lock:
        LAUNCHES += 1
    return x.reshape(*lead, r)


def solve_spd_reference(A: torch.Tensor, b: torch.Tensor,
                        jitter: float = 1e-6) -> torch.Tensor:
    """The plain version, batched over every leading axis: the TPU
    kernel's in-place right-looking Cholesky (pivot clamped before the
    rsqrt), right-looking forward substitution and left-looking backward
    substitution, each division clamped. Computes in f32 (the kernel's
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
