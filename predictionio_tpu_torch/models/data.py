"""Event log -> training matrix: the port's own copy of
``predictionio_tpu/models/data.py``.

String-keyed events become dense integer COO ratings and the two id
``BiMap``s, element for element as the JAX package makes them, and
:func:`kfold_split` cuts them into the evaluation's folds.

The sharded rating sources feed a training of several processes without
any process holding the whole COO: :class:`ColumnarRatingsSource` reads
the rating triples of a factor-row range (or row set) straight off a
columnar batch, and :class:`ShardedColumnarRatingsSource` does so from
this process's storage shard alone, agreeing on the id indexation with
one count all-reduce and fetching the other shards' triples through the
host shuffle (``parallel/multihost.py``).
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


class ColumnarRatingsSource:
    """Per-shard rating reads off a columnar batch: each process
    materializes only the rating triples whose factor row falls in its
    shard. Its own state is one selection mask and the code -> row
    lookup tables; reads stream through ``chunk``-row temporaries.

    Every process derives the same id indexation (``BiMap``s in
    dictionary-code order of the observed codes) from the same batch;
    ``count_reduce`` (an all-reduce over processes) turns per-shard code
    counts into the global ones, so processes holding different storage
    shards agree too."""

    def __init__(self, batch,
                 event_weights: Optional[Dict[str, Optional[float]]] = None,
                 chunk: int = 4_000_000, count_reduce=None):
        self.batch = batch
        self.chunk = chunk
        #: global storage-row index of this batch's first row (a shard
        #: sets it from its ``shard_offset``)
        self._pos_base = 0
        if event_weights is None:
            event_weights = {"rate": None, "buy": 4.0}
        d = batch.dicts
        # the selection of the one-shot COO conversion: the two paths
        # must never drift, or the shards stop adding up to the COO
        self._fixed = {d.event_names.index[nm]: w
                       for nm, w in event_weights.items()
                       if nm in d.event_names.index}
        needs_prop = any(w is None for w in self._fixed.values())
        sel, _ = rating_selection(
            batch.event, batch.target_id,
            batch.float_prop("rating") if needs_prop else None,
            self._fixed)
        self._sel = sel
        self._needs_prop = needs_prop
        u_counts = np.bincount(np.asarray(batch.entity_id)[sel],
                               minlength=max(len(d.entity_ids), 1))
        i_counts = np.bincount(np.asarray(batch.target_id)[sel],
                               minlength=max(len(d.target_ids), 1))
        if count_reduce is not None:
            u_counts = count_reduce(u_counts)
            i_counts = count_reduce(i_counts)
        u_uniq = np.flatnonzero(u_counts)
        i_uniq = np.flatnonzero(i_counts)
        self._u_lut = np.full(max(len(d.entity_ids), 1), -1, np.int64)
        self._u_lut[u_uniq] = np.arange(len(u_uniq))
        self._i_lut = np.full(max(len(d.target_ids), 1), -1, np.int64)
        self._i_lut[i_uniq] = np.arange(len(i_uniq))
        uv, iv = d.entity_ids.values, d.target_ids.values
        self.user_ids = BiMap({uv[c]: j for j, c in enumerate(u_uniq)})
        self.item_ids = BiMap({iv[c]: j for j, c in enumerate(i_uniq)})
        self.n_users = len(u_uniq)
        self.n_items = len(i_uniq)
        self._u_counts = u_counts[u_uniq]
        self._i_counts = i_counts[i_uniq]

    def row_counts(self, side: str) -> np.ndarray:
        """Every factor row's rating count on ``side`` (global)."""
        return self._u_counts if side == "user" else self._i_counts

    def _values(self, lo: int, hi: int) -> np.ndarray:
        _, vals = rating_selection(
            self.batch.event[lo:hi], self.batch.target_id[lo:hi],
            (self.batch.float_prop("rating")[lo:hi]
             if self._needs_prop else None), self._fixed)
        return vals.astype(np.float32)

    def _read_filtered_pos(self, side: str, row_pred):
        """The selected triples whose ``side`` row passes ``row_pred`` (a
        vectorized predicate over int64 rows; None keeps all), streamed
        in chunks: ``(pos, rows, cols, vals)`` with ``pos`` the triples'
        global storage positions. One loop serves every read, so the
        range, row-set and sharded reads cannot drift apart."""
        row_lut, col_lut, row_col, col_col = (
            (self._u_lut, self._i_lut, self.batch.entity_id,
             self.batch.target_id) if side == "user" else
            (self._i_lut, self._u_lut, self.batch.target_id,
             self.batch.entity_id))
        pos_out, rows_out, cols_out, vals_out = [], [], [], []
        n = self.batch.n
        for lo in range(0, n, self.chunk):
            hi = min(lo + self.chunk, n)
            m = self._sel[lo:hi].copy()
            if not m.any():
                continue
            r = row_lut[np.asarray(row_col[lo:hi])]
            if row_pred is not None:
                m &= row_pred(r)
                if not m.any():
                    continue
            vals = self._values(lo, hi)
            pos_out.append(np.flatnonzero(m).astype(np.int64)
                           + (lo + self._pos_base))
            rows_out.append(r[m])
            cols_out.append(col_lut[np.asarray(col_col[lo:hi])][m])
            vals_out.append(vals[m])
        if not rows_out:
            z = np.empty(0, np.int64)
            return z, z, z.copy(), np.empty(0, np.float32)
        return (np.concatenate(pos_out), np.concatenate(rows_out),
                np.concatenate(cols_out), np.concatenate(vals_out))

    def _read_filtered(self, side: str, row_pred):
        _, rows, cols, vals = self._read_filtered_pos(side, row_pred)
        return rows, cols, vals

    def read_rows(self, side: str, start: int, stop: int):
        """Every triple whose ``side`` factor row is in ``[start, stop)``,
        as ``(rows, cols, values)`` in storage order."""
        return self._read_filtered(
            side, lambda r: (r >= start) & (r < stop))

    def read_row_mask(self, side: str, mask: np.ndarray):
        """Every triple whose ``side`` factor row has ``mask[row]`` True
        (the bucketed layout gives a process a row set, not a range)."""
        return self._read_filtered(
            side, lambda r: mask[np.maximum(r, 0)] & (r >= 0))

    def to_coo(self) -> RatingsCOO:
        """The whole COO (collective for a sharded source)."""
        rows, cols, vals = self.read_rows("user", 0, self.n_users)
        return RatingsCOO(rows.astype(np.int32), cols.astype(np.int32),
                          vals, self.n_users, self.n_items)


class ShardedColumnarRatingsSource(ColumnarRatingsSource):
    """The training read pushed all the way down: each process holds
    only its storage shard of the log (``find_columnar(shard=(rank,
    world))``), agrees on the id indexation through one count
    all-reduce, and gets each factor row's triples through the chunked
    host shuffle (``exchange_filtered``). The triples come back in global
    storage order (their positions cross the shuffle too), so packing,
    ``max_history`` truncation included, is the unsharded read's.

    Collective: every process builds this source and issues the same
    reads in the same order (``pack_ratings_multihost`` does)."""

    def __init__(self, shard_batch,
                 event_weights: Optional[Dict[str, Optional[float]]] = None,
                 chunk: int = 4_000_000,
                 exchange_chunk: int = 4_000_000):
        from ..parallel.multihost import allreduce_sum

        super().__init__(shard_batch, event_weights, chunk,
                         count_reduce=allreduce_sum)
        self._pos_base = int(getattr(shard_batch, "shard_offset", 0))
        self.exchange_chunk = exchange_chunk

    def _read_filtered(self, side: str, row_pred):
        from ..parallel.multihost import exchange_filtered

        # the local pass takes every selected triple of this storage
        # shard; the row predicate holds on the receiving side
        pos, rows, cols, vals = self._read_filtered_pos(side, None)
        pred = row_pred if row_pred is not None \
            else (lambda r: np.ones(len(r), dtype=bool))
        pos, rows, cols, vals = exchange_filtered(
            [pos, rows, cols, vals], keep=lambda p, r, c, v: pred(r),
            chunk=self.exchange_chunk)
        order = np.argsort(pos, kind="stable")
        return rows[order], cols[order], vals[order]
