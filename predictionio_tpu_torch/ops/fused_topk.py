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
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

#: largest k the kernel's running top-k list holds (``csrc/fused_topk.cu``
#: kMaxK); larger k goes to ``models/als.py::_serve_topk``
TOPK_MAX_K = 128

#: largest rank the kernel's shared-memory tile takes (kMaxRank)
TOPK_MAX_RANK = 256

#: kernel launches since the last reset (a plain count; ``chip_smoke.py``
#: zeroes it before driving the serving path and reads it after)
LAUNCHES = 0
_launch_lock = threading.Lock()

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
                           + [ctypes.c_int] * 7
                           + [ctypes.c_void_p] * 3)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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
    global LAUNCHES
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
    fn = getattr(_kernel_lib(), _ENTRY[user_table.dtype])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(dev.index, user_table.data_ptr(), idx.data_ptr(),
             item_table.data_ptr(),
             None if user_scale is None else user_scale.data_ptr(),
             None if item_scale is None else item_scale.data_ptr(),
             B, user_table.shape[0], item_table.shape[0],
             user_table.shape[1], k, int(base or 0), int(n_items),
             out_s.data_ptr(), out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_topk kernel launch failed: CUDA error "
                           f"{err}")
    with _launch_lock:
        LAUNCHES += 1
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
