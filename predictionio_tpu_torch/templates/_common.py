"""Shared helpers of the item-recommendation templates (the port's own
copy of ``predictionio_tpu/templates/_common.py``).

The similar-product and e-commerce templates share: the deduplicated
view-count ratings, the candidate-item filter and the top-N selection.
All three are host numpy, as in the JAX package: these templates score
on the host. Their models store the item categories through
:func:`items_json` and :func:`items_from_json`. All three ALS templates
train through :func:`train_als_on`, which picks the context's device or
its mesh.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

import torch

from ..controller.context import Context
from ..data.bimap import BiMap
from ..models.als import (
    ALSParams,
    RatingsCOO,
    pack_ratings_cached,
    train_als,
    unshard_table,
)


def train_als_on(ctx: Context, ratings: RatingsCOO, params: ALSParams
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack once per ratings object and train on ``ctx.device``, or over
    ``ctx.mesh`` (in a process group of several processes, the global
    mesh); a mesh's factors are gathered to whole tables. Returns the
    padded ``(U, V)`` on the device the training ran on."""
    from ..parallel.multihost import global_mesh, process_count

    mesh = ctx.mesh
    if mesh is None and process_count() > 1:
        mesh = global_mesh(device=ctx.device)
    if mesh is None:
        packed = pack_ratings_cached(ratings, params, device=ctx.device)
        return train_als(ratings, params, device=ctx.device, packed=packed)
    packed = pack_ratings_cached(ratings, params, mesh=mesh)
    U, V = train_als(ratings, params, mesh=mesh, packed=packed)
    return unshard_table(U), unshard_table(V)


def dedup_view_ratings(events: Iterable, user_ids: BiMap,
                       item_ids: BiMap) -> RatingsCOO:
    """COO of per-(user, item) event counts; events need .user/.item."""
    counts: Dict[Tuple[int, int], float] = {}
    for v in events:
        u, i = user_ids.get(v.user), item_ids.get(v.item)
        if u is None or i is None:
            continue
        counts[(u, i)] = counts.get((u, i), 0.0) + 1.0
    if not counts:
        raise ValueError("no valid events to train on")
    keys = np.array(list(counts.keys()), dtype=np.int32)
    vals = np.array(list(counts.values()), dtype=np.float32)
    return RatingsCOO(users=keys[:, 0], items=keys[:, 1], ratings=vals,
                      n_users=len(user_ids), n_items=len(item_ids))


def candidate_mask(items: Dict[int, object], n_items: int, item_ids: BiMap,
                   white_list: Optional[Sequence[str]] = None,
                   black_list: Iterable[str] = (),
                   exclude_idx: Iterable[int] = (),
                   categories: Optional[Sequence[str]] = None,
                   category_black_list: Optional[Sequence[str]] = None,
                   ) -> np.ndarray:
    """Boolean [I] filter; ``items`` values expose ``.categories``.

    Semantics of the reference's ``isCandidateItem``: whitelist keeps only
    listed items; blacklist and the query's own items are dropped; with a
    ``categories`` filter, items lacking any overlapping category
    (including items with no categories at all) are dropped."""
    mask = np.ones(n_items, dtype=bool)
    if white_list is not None:
        white = np.zeros(n_items, dtype=bool)
        for it in white_list:
            idx = item_ids.get(it)
            if idx is not None:
                white[idx] = True
        mask &= white
    for it in black_list:
        idx = item_ids.get(it)
        if idx is not None:
            mask[idx] = False
    for idx in exclude_idx:
        if 0 <= idx < n_items:
            mask[idx] = False
    if categories is not None:
        cats = set(categories)
        for i in np.flatnonzero(mask):
            item_cats = getattr(items.get(int(i)), "categories", None)
            mask[i] = bool(item_cats) and bool(set(item_cats) & cats)
    if category_black_list is not None:
        bad = set(category_black_list)
        for i in np.flatnonzero(mask):
            item_cats = getattr(items.get(int(i)), "categories", None) or ()
            if set(item_cats) & bad:
                mask[i] = False
    return mask


def top_scores(scores: np.ndarray, mask: np.ndarray, num: int,
               positive_only: bool = True) -> List[Tuple[int, float]]:
    """Top-``num`` (index, score) over the masked scores, descending;
    O(I) partition + O(num log num) sort."""
    s = np.where(mask, scores, -np.inf)
    if positive_only:
        s = np.where(s > 0, s, -np.inf)
    k = min(num, len(s))
    if k <= 0:
        return []
    idx = np.argpartition(-s, k - 1)[:k] if k < len(s) else np.argsort(-s)
    idx = idx[np.argsort(-s[idx], kind="stable")]
    return [(int(i), float(s[i])) for i in idx if np.isfinite(s[i])]


def items_json(items: Dict[int, Any]) -> List[list]:
    """Item categories as JSON: ``[[index, [category, ...] or None]]``."""
    return [[int(k), None if v.categories is None else list(v.categories)]
            for k, v in items.items()]


def items_from_json(rows: List[list], item_cls) -> Dict[int, Any]:
    """Invert :func:`items_json` into ``item_cls`` values."""
    return {k: item_cls(categories=None if c is None else tuple(c))
            for k, c in rows}
