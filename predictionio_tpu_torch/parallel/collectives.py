"""The serving collective: the global top-k of row-sharded candidates
(``sharded_top_k`` of ``predictionio_tpu/parallel/collectives.py``).

The JAX package all-gathers each shard's local top-k inside a
``shard_map`` and reduces the ``k * n_shards`` candidates to the global
top-k. Here the shards are launches of one process, so the gather is a
copy of each shard's ``[B, k]`` candidates onto the first shard's device
and the reduction a sort there: :func:`merge_candidates`, in the
serving kernel's own total order (score descending, then id ascending).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from ..ops.fused_topk import merge_partial_topk
from .mesh import MODEL_AXIS, ServingMesh


def merge_candidates(scores: Sequence[torch.Tensor],
                     ids: Sequence[torch.Tensor], k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` best of per-shard candidate lists (``[B, k_s]`` scores
    and GLOBAL ids each, any devices) by (score descending, id
    ascending): ``(scores [B, k], ids [B, k])`` on the first list's
    device. The order is total, so the result is what one ranking of
    the whole table gives."""
    dev = scores[0].device
    s = torch.cat([t.to(dev) for t in scores], dim=1)
    i = torch.cat([t.to(dev).to(torch.int32) for t in ids], dim=1)
    return merge_partial_topk(s[:, None, :], i[:, None, :], k=k)


def sharded_top_k(scores: Union[torch.Tensor, Sequence[torch.Tensor]],
                  k: int, mesh: ServingMesh, axis: str = MODEL_AXIS
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k over a score vector split evenly over ``mesh``'s
    ``axis``: a local top-k per shard (ids offset by the shard's origin),
    then :func:`merge_candidates` of the ``k * n_shards`` candidates.
    ``scores`` is the whole ``[..., n]`` vector or its per-shard blocks.
    Returns ``(global indices, values)``, the JAX package's order."""
    n_shards = mesh.axis_size(axis)
    if isinstance(scores, torch.Tensor):
        if scores.shape[-1] % n_shards:
            raise ValueError(f"{scores.shape[-1]} scores do not split over "
                             f"{n_shards} shards of axis {axis!r}")
        blocks = list(torch.chunk(scores, n_shards, dim=-1))
    else:
        blocks = list(scores)
    lead = tuple(blocks[0].shape[:-1])
    vals, gids, base = [], [], 0
    for block in blocks:
        b2 = block.reshape(-1, block.shape[-1]).float()
        kk = min(k, b2.shape[1])
        s, pos = torch.sort(b2, dim=1, descending=True, stable=True)
        vals.append(s[:, :kk])
        gids.append(pos[:, :kk] + base)
        base += block.shape[-1]
    v, i = merge_candidates(vals, gids, k)
    return i.long().reshape(lead + (k,)), v.reshape(lead + (k,))
