"""Multi-head attention with causal and key-validity masks (the port of
``predictionio_tpu/ops/ring_attention.py``).

Only the one-card path is ported: :func:`ring_attention` with
``mesh=None`` computes what the JAX package's
``_ring_attention_local_nodist`` computes, as plain torch ops on
``[B, S, H, D]`` tensors. Scores are f32 whatever the input dtype (a
float64 input, a host reference's, stays float64); the causal mask and the key-validity mask set masked scores to ``-inf``; a
row whose every key is masked returns 0, never NaN; the output has
``q``'s dtype. ``F.scaled_dot_product_attention`` is not used: its fully
masked rows give NaN, and the sequential model's left-padded windows
make such rows in every batch.

The ring over many cards (the sequence sharded, KV blocks rotating
between them) waits for ``ROADMAP.md`` queue 1 item 13.
"""

from __future__ import annotations

from typing import Optional

import torch

_RING_TODO = ("ring_attention over a mesh is not ported: the ring over "
              "torch.distributed is ROADMAP.md queue 1 item 13")


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh=None, axis: str = "data", causal: bool = False,
                   scale: Optional[float] = None,
                   key_valid: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Dense softmax attention. q/k/v: ``[batch, seq, heads, head_dim]``;
    ``key_valid`` ([batch, seq] bool) masks key positions (the padding
    slots of left-padded windows). ``mesh`` must be None."""
    if mesh is not None:
        raise NotImplementedError(_RING_TODO)
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    # f32 scores whatever the wire dtype (a float64 input stays float64)
    ct = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct)) * scale
    if causal:
        S = q.shape[1]
        pos = torch.arange(S, device=q.device)
        mask = pos[:, None] >= pos[None, :]
        s = s.masked_fill(~mask[None, None], float("-inf"))
    if key_valid is not None:
        s = s.masked_fill(~key_valid[:, None, None, :].bool(),
                          float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m).detach()
    p = torch.exp(s - m)  # masked slots: exp(-inf) = 0
    denom = p.sum(dim=-1, keepdim=True)
    # both branches stay finite, so the backward never multiplies 0 by inf
    p = torch.where(denom > 0, p / denom.clamp_min(1e-30),
                    torch.zeros_like(p))
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(ct)).to(q.dtype)
