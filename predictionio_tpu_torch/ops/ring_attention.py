"""Multi-head attention with causal and key-validity masks, on one card
or as a ring over a mesh (the port of
``predictionio_tpu/ops/ring_attention.py``).

With ``mesh=None``, :func:`ring_attention` computes what the JAX
package's ``_ring_attention_local_nodist`` computes, as plain torch ops
on ``[B, S, H, D]`` tensors. Scores are f32 whatever the input dtype (a
float64 input, a host reference's, stays float64); the causal mask and
the key-validity mask set masked scores to ``-inf``; a row whose every
key is masked returns 0, never NaN; the output has ``q``'s dtype.
``F.scaled_dot_product_attention`` is not used: its fully masked rows
give NaN, and the sequential model's left-padded windows make such rows
in every batch.

With a mesh, the sequence is cut over the mesh axis ``axis`` (the JAX
package's ``P(None, axis)``: positions along the other axes hold the
same block) and each position keeps its ``[B, S/P, H, D]`` block of
queries while the key, value and key-validity blocks go round the ring
(:func:`~predictionio_tpu_torch.parallel.collectives.ring_permute`: one
block to one neighbour, point to point between processes). The ring
runs P steps and rotates at the start of every step after the first
(P - 1 rotations); at step j a position holds the block first owned by
position ``(idx - j) mod P``, and the causal mask compares global
positions. Each block folds into a running max ``m``, normalizer ``l``
and weighted accumulator in f32 (float64 for a float64 input), the
streaming softmax of the JAX package's ``_ring_attention_local``: the
result is the dense one up to rounding. As in the JAX package the block
products are plain contractions (``torch.einsum``), not a kernel.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from ..parallel.collectives import _assemble, _split, axis_index, ring_permute

Blocks = Union[torch.Tensor, Sequence[torch.Tensor]]


def ring_attention(q: Blocks, k: Blocks, v: Blocks, mesh=None,
                   axis: str = "data", causal: bool = False,
                   scale: Optional[float] = None,
                   key_valid: Optional[Blocks] = None) -> Blocks:
    """Softmax attention. q/k/v: ``[batch, seq, heads, head_dim]``;
    ``key_valid`` ([batch, seq] bool) masks key positions (the padding
    slots of left-padded windows). With ``mesh`` the sequence splits
    over its axis ``axis`` (``seq`` must divide by the axis size): the
    inputs are whole tensors, or the per-position blocks of
    :func:`sequence_shard`, and the output comes back in the same
    form."""
    if mesh is not None:
        return _ring(q, k, v, mesh, axis, causal, scale, key_valid)
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


def sequence_shard(x: torch.Tensor, mesh, axis: str = "data"
                   ) -> List[torch.Tensor]:
    """This process's blocks of ``[batch, seq, ...]`` with the sequence
    split over ``mesh``'s axis ``axis``, one a local position on its
    device (the layout :func:`ring_attention` consumes); a sequence that
    does not divide by the axis size raises ValueError."""
    return _split(x, mesh, (axis,), dim=1)


def _blocks(x: Blocks, mesh, axis: str) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return sequence_shard(x, mesh, axis)
    blocks = list(x)
    if len(blocks) != len(mesh.local_positions()):
        raise ValueError(f"{len(blocks)} blocks for the "
                         f"{len(mesh.local_positions())} positions this "
                         f"process owns")
    return blocks


def _ring(q, k, v, mesh, axis: str, causal: bool, scale: Optional[float],
          key_valid) -> Blocks:
    """The ring over ``mesh``'s ``axis`` (module docstring)."""
    whole = isinstance(q, torch.Tensor)
    qb, kb, vb = (_blocks(x, mesh, axis) for x in (q, k, v))
    if key_valid is None:
        kmb = [torch.ones(b.shape[:2], dtype=torch.bool, device=b.device)
               for b in qb]
    else:
        kmb = [b.bool() for b in _blocks(key_valid, mesh, axis)]
    n = mesh.axis_size(axis)
    B, S_loc, H, D = qb[0].shape
    if scale is None:
        scale = float(D) ** -0.5
    ct = torch.promote_types(qb[0].dtype, torch.float32)
    local = mesh.local_positions()
    idx = [axis_index(mesh, p, axis) for p in local]
    m = [torch.full((B, H, S_loc), float("-inf"), dtype=ct,
                    device=b.device) for b in qb]
    l_ = [torch.zeros((B, H, S_loc), dtype=ct, device=b.device) for b in qb]
    acc = [torch.zeros((B, S_loc, H, D), dtype=ct, device=b.device)
           for b in qb]
    qf = [b.to(ct) for b in qb]
    for j in range(n):
        if j > 0:
            kb = ring_permute(kb, axis, 1, mesh=mesh)
            vb = ring_permute(vb, axis, 1, mesh=mesh)
            kmb = ring_permute(kmb, axis, 1, mesh=mesh)
        for t in range(len(local)):
            dev = qb[t].device
            s = torch.einsum("bqhd,bkhd->bhqk", qf[t],
                             kb[t].to(ct)) * scale
            if causal:
                q_pos = idx[t] * S_loc + torch.arange(S_loc, device=dev)
                kv_pos = ((idx[t] - j) % n) * S_loc + torch.arange(
                    S_loc, device=dev)
                s = s.masked_fill(~(q_pos[:, None] >= kv_pos[None, :])
                                  [None, None], float("-inf"))
            s = s.masked_fill(~kmb[t][:, None, None, :], float("-inf"))
            m_new = torch.maximum(m[t], s.amax(dim=-1))
            # rows with nothing attendable yet keep m = -inf: shift by 0
            shift = torch.where(torch.isinf(m_new),
                                torch.zeros_like(m_new), m_new)
            p = torch.exp(s - shift[..., None])  # masked slots: 0
            corr = torch.where(torch.isinf(m[t]), torch.zeros_like(m[t]),
                               torch.exp(m[t] - shift))
            l_[t] = l_[t] * corr + p.sum(dim=-1)
            pv = torch.einsum("bhqk,bkhd->bqhd", p, vb[t].to(ct))
            acc[t] = acc[t] * corr.transpose(1, 2)[..., None] + pv
            m[t] = m_new
    # a row that saw no key has l = 0 and acc = 0: 0, never NaN
    out = [(a / l.clamp_min(1e-30).transpose(1, 2)[..., None]).to(b.dtype)
           for a, l, b in zip(acc, l_, qb)]
    return _assemble(out, mesh, (axis,), dim=1) if whole else out
