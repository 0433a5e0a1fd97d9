"""Event log -> training matrix: the port's own copy of the single-process
half of ``predictionio_tpu/models/data.py``.

String-keyed events become dense integer COO ratings and the two id
``BiMap``s, element for element as the JAX package makes them, and
:func:`kfold_split` cuts them into the evaluation's folds. Left out
(``ROADMAP.md`` queue 1): the sharded multi-host rating sources.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from ..data.bimap import BiMap
from ..data.event import Event
from .als import RatingsCOO


def ratings_from_events(
        events: Iterable[Event],
        event_weights: Optional[Dict[str, Optional[float]]] = None,
        user_ids: Optional[BiMap] = None,
        item_ids: Optional[BiMap] = None,
) -> Tuple[RatingsCOO, BiMap, BiMap]:
    """Turn rate/buy-style events into COO ratings and id maps.

    ``event_weights`` maps event name -> fixed rating (None: read the
    ``rating`` property); the default takes ``rate`` with its rating and
    ``buy`` as 4.0. Later duplicates are kept as separate entries.
    """
    if event_weights is None:
        event_weights = {"rate": None, "buy": 4.0}

    users, items, vals = [], [], []
    for e in events:
        if e.event not in event_weights:
            continue
        if e.target_entity_id is None:
            continue
        w = event_weights[e.event]
        if w is None:
            w = e.properties.get("rating", float, default=None)
            if w is None:
                continue
        users.append(e.entity_id)
        items.append(e.target_entity_id)
        vals.append(float(w))

    if user_ids is None:
        user_ids = BiMap.string_int(users)
    if item_ids is None:
        item_ids = BiMap.string_int(items)

    u = user_ids.map_array(users)
    i = item_ids.map_array(items)
    v = np.asarray(vals, dtype=np.float32)
    keep = (u >= 0) & (i >= 0)
    return (RatingsCOO(u[keep].astype(np.int32), i[keep].astype(np.int32),
                       v[keep], len(user_ids), len(item_ids)),
            user_ids, item_ids)


def ratings_from_columnar(
        batch,
        event_weights: Optional[Dict[str, Optional[float]]] = None,
        user_ids: Optional[BiMap] = None,
        item_ids: Optional[BiMap] = None,
) -> Tuple[RatingsCOO, BiMap, BiMap]:
    """Vectorized :func:`ratings_from_events` over a
    :class:`~predictionio_tpu_torch.data.columnar.ColumnarBatch`: no
    per-event Python objects on the training read path.

    Semantics match the row version: later duplicates kept, events with a
    ``None`` weight read the ``rating`` float property (rows without one
    are dropped), ids absent from provided BiMaps are dropped. Users and
    items are numbered in the order of their dictionary codes, as in the
    JAX package, so both packages give the same arrays and maps.
    """
    if event_weights is None:
        event_weights = {"rate": None, "buy": 4.0}

    d = batch.dicts
    by_code = {d.event_names.index[nm]: w
               for nm, w in event_weights.items()
               if nm in d.event_names.index}
    needs_prop = any(w is None for w in by_code.values())
    sel, vals = rating_selection(
        batch.event, batch.target_id,
        batch.float_prop("rating") if needs_prop else None, by_code)

    u_codes = batch.entity_id[sel]
    i_codes = batch.target_id[sel]
    v = vals[sel].astype(np.float32)

    def densify(codes: np.ndarray, sd, ids: Optional[BiMap]):
        if ids is None:
            # bincount beats np.unique (no sort): codes are small dense
            # dictionary ints
            counts = np.bincount(codes, minlength=len(sd)) \
                if len(codes) else np.zeros(len(sd), dtype=np.int64)
            uniq = np.flatnonzero(counts)
            lut = np.full(max(len(sd), 1), -1, dtype=np.int64)
            lut[uniq] = np.arange(len(uniq))
            inv = lut[codes] if len(codes) else np.empty(0, np.int64)
            values = sd.values
            return BiMap({values[c]: j for j, c in enumerate(uniq)}), \
                inv, None
        lut = np.full(max(len(sd), 1), -1, dtype=np.int64)
        for s, j in ids.items():
            c = sd.index.get(s)
            if c is not None:
                lut[c] = j
        mapped = lut[codes] if len(codes) else \
            np.empty(0, dtype=np.int64)
        return ids, mapped, mapped >= 0

    user_ids, u, keep_u = densify(u_codes, d.entity_ids, user_ids)
    item_ids, i, keep_i = densify(i_codes, d.target_ids, item_ids)
    keep = None
    if keep_u is not None:
        keep = keep_u
    if keep_i is not None:
        keep = keep_i if keep is None else (keep & keep_i)
    if keep is not None:
        u, i, v = u[keep], i[keep], v[keep]
    return (RatingsCOO(u.astype(np.int32), i.astype(np.int32), v,
                       len(user_ids), len(item_ids)),
            user_ids, item_ids)


def kfold_split(n: int, k: int, seed: int = 0) -> list:
    """Index masks ``[(train, test)]`` for k-fold cross-validation over
    ``n`` COO entries: entry ``j`` is held out of fold
    ``default_rng(seed).integers(0, k, size=n)[j]``, the JAX package's
    draw, so both packages make the same folds bit for bit."""
    rng = np.random.default_rng(seed)
    fold_of = rng.integers(0, k, size=n)
    return [(fold_of != f, fold_of == f) for f in range(k)]


def rating_selection(event_col, target_col, rating_col,
                     weights_by_code: Dict[int, Optional[float]]):
    """Event selection and weights of the training read: fixed-weight
    events always select; None-weight events read the ``rating`` float
    column and drop NaN rows; rows without a target never select.

    Returns ``(sel bool [n], vals float64 [n])`` (vals NaN outside
    ``sel``; ``rating_col`` may be None when no event needs it)."""
    ev = np.asarray(event_col)
    n = len(ev)
    sel = np.zeros(n, dtype=bool)
    vals = np.full(n, np.nan, dtype=np.float64)
    for code, w in weights_by_code.items():
        m = ev == code
        if w is None:
            assert rating_col is not None, \
                "None-weight events need the rating column"
            col = np.asarray(rating_col)
            vals = np.where(m, col, vals)
            sel |= m & ~np.isnan(col)
        else:
            vals = np.where(m, float(w), vals)
            sel |= m
    sel &= np.asarray(target_col) >= 0
    return sel, vals
