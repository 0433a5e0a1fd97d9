"""Weighted Gramians of gathered factor rows, in plain PyTorch (the port
of ``predictionio_tpu/ops/gram.py``'s ``gram_weighted`` and
``gram_dispatch``).

``A[..., :, :] = sum_l w[..., l] * f_l f_l^T`` over ``F[..., L, r]``.
These run outside any kernel in the JAX package too, so they stay
``torch.einsum`` here. The JAX package's "pair" mode packs two rank-r
systems into one 128x128 MXU tile; that is a TPU tiling with the same
result, so in the port "pair" is the same function as "einsum".
"""

from __future__ import annotations

import torch

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
        Fw = (F * w[..., None]).bfloat16().float()
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
