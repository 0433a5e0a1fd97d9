"""Micro-batch fold-in assembly: events -> per-entity re-solves (the port
of ``predictionio_tpu/streaming/foldin.py``).

Turns a batch of freshly consumed events into a NEW serving model:

1. project events to ``(user, item, rating)`` triples with the same
   event -> rating weighting the batch data source uses (``rate`` reads
   the rating property, ``buy`` implies 4.0, custom maps supported);
2. split the touched entities into existing users (fold-in), new users
   and new items (cold-start insertion);
3. re-read each affected entity's FULL history from the event store, so
   a row is a pure function of its history and the fixed opposite
   factors, and replay is idempotent;
4. deduplicate repeated (user, item) pairs last-write-wins
   (:func:`~predictionio_tpu_torch.models.als.dedupe_pairs`);
5. solve through :func:`~predictionio_tpu_torch.models.als.fold_in_rows`
   (``fused_gram`` and ``chol_solve`` on the card, as in training) and
   assemble the updated model functionally: the old binding keeps
   serving until the swap.

New items solve first (against known users), then user rows solve
against the item table that already includes them, so a brand-new user's
first event on a brand-new item lands both rows in one pass.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.event import Event
from ..data.storage.base import EventFilter
from ..models.als import (
    ALSModel,
    apply_row_updates,
    dedupe_pairs,
    extend_factor_rows,
    fixed_gramian,
    fold_in_rows,
    table_rows_f32,
)

log = logging.getLogger(__name__)

__all__ = ["FoldInReport", "project_ratings", "fold_in_events",
           "DEFAULT_EVENT_WEIGHTS"]

#: event -> rating projection, matching the recommendation data source's
#: default (None: read the ``rating`` property)
DEFAULT_EVENT_WEIGHTS: Dict[str, Optional[float]] = {"rate": None,
                                                     "buy": 4.0}


@dataclass
class FoldInReport:
    """What one fold-in pass did: the trainer's status and drift input."""

    events_relevant: int = 0
    users_updated: int = 0
    users_inserted: int = 0
    items_inserted: int = 0
    #: mean |u.v - r| over the batch triples AFTER the solve, normalized
    #: by the batch's rating scale: the fold-in residual the
    #: DriftMonitor tracks (None when nothing was solvable)
    residual: Optional[float] = None
    #: projected rating values of the batch (drift's distribution input)
    values: List[float] = field(default_factory=list)


def project_ratings(events: Sequence[Event],
                    weights: Optional[Dict[str, Optional[float]]] = None
                    ) -> List[Tuple[str, str, float]]:
    """``(user_key, item_key, rating)`` triples from raw events, in event
    order; events outside the weight map, without a target item, or with
    an unreadable rating are skipped."""
    weights = DEFAULT_EVENT_WEIGHTS if weights is None else weights
    out: List[Tuple[str, str, float]] = []
    for e in events:
        if e.event not in weights or e.entity_type != "user" \
                or not e.target_entity_id:
            continue
        w = weights[e.event]
        if w is None:
            try:
                w = float(e.properties["rating"])
            except (KeyError, TypeError, ValueError):
                continue
        out.append((e.entity_id, e.target_entity_id, float(w)))
    return out


def _entity_history(storage, app_id: int, channel_id, entity_id: str,
                    event_names: Sequence[str], by_item: bool = False
                    ) -> List[Event]:
    """One entity's full rating history, oldest first. ``by_item`` scans
    by target entity (no indexed column serves it: a full-filter scan;
    cold items are rare and their history short)."""
    if by_item:
        filt = EventFilter(entity_type="user",
                           event_names=list(event_names),
                           target_entity_type="item",
                           target_entity_id=entity_id)
    else:
        filt = EventFilter(entity_type="user", entity_id=entity_id,
                           event_names=list(event_names),
                           target_entity_type="item")
    return list(storage.events().find(app_id, channel_id, filt))


def _pack_histories(triples: List[Tuple[int, float]], max_history: int
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
    """One row's deduped ``(col, value)`` list -> fixed arrays, keeping
    the MOST RECENT ``max_history`` entries."""
    if len(triples) > max_history:
        triples = triples[-max_history:]
    idx = np.fromiter((c for c, _ in triples), dtype=np.int32,
                      count=len(triples))
    val = np.fromiter((v for _, v in triples), dtype=np.float32,
                      count=len(triples))
    return idx, val, len(triples)


def _solve_side(model: ALSModel, side: str,
                rows: List[Tuple[str, List[Tuple[int, float]]]],
                max_history: int, G=None) -> Tuple[List[str], np.ndarray]:
    """Batch-solve one side's rows from their (col_idx, value) lists.
    Returns (keys, [B, rank] rows); empty-history rows solve to ~0
    through the regularized system (count 0: b = 0). The block is as
    wide as the longest history, capped at ``max_history``."""
    keys = [k for k, _ in rows]
    if not keys:
        return keys, np.zeros((0, model.params.rank), np.float32)
    L = max(1, max(len(t) for _, t in rows))
    L = min(L, max_history)
    B = len(rows)
    idx = np.zeros((B, L), dtype=np.int32)
    val = np.zeros((B, L), dtype=np.float32)
    cnt = np.zeros(B, dtype=np.int32)
    for b, (_, triples) in enumerate(rows):
        i, v, n = _pack_histories(triples, L)
        idx[b, :n] = i
        val[b, :n] = v
        cnt[b] = n
    fixed = model.item_factors if side == "user" else model.user_factors
    solved = fold_in_rows(fixed, idx, val, cnt, model.params, G=G)
    return keys, solved


def fold_in_events(model: ALSModel, events: Sequence[Event], storage,
                   app_id: int, channel_id=None,
                   weights: Optional[Dict[str, Optional[float]]] = None,
                   max_history: int = 512,
                   G=None) -> Tuple[ALSModel, FoldInReport]:
    """Fold a consumed event batch into ``model``; returns the NEW model
    and a :class:`FoldInReport`. The input model is never written:
    callers swap the result into the serving binding. ``G`` optionally
    carries the cached fixed-side Gramian of an implicit model
    (:func:`~predictionio_tpu_torch.models.als.fixed_gramian`, valid
    until the item table changes)."""
    report = FoldInReport()
    weights = DEFAULT_EVENT_WEIGHTS if weights is None else weights
    triples = project_ratings(events, weights)
    report.events_relevant = len(triples)
    if not triples:
        return model, report
    report.values = [v for _, _, v in triples]
    event_names = list(weights)

    touched_users = list(dict.fromkeys(u for u, _, _ in triples))
    touched_items = list(dict.fromkeys(i for _, i, _ in triples))
    new_items = [i for i in touched_items
                 if model.item_ids is None or i not in model.item_ids]

    # -- cold-start items first: their rows must exist before user rows
    # solve against the item table --------------------------------------
    if new_items:
        item_rows: List[Tuple[str, List[Tuple[int, float]]]] = []
        for ikey in new_items:
            hist = project_ratings(
                _entity_history(storage, app_id, channel_id, ikey,
                                event_names, by_item=True), weights)
            u, _, v = dedupe_pairs(
                np.array([model.user_ids.get(uu, -1) if model.user_ids
                          else -1 for uu, _, _ in hist], dtype=np.int64),
                np.zeros(len(hist), dtype=np.int64),
                np.array([vv for _, _, vv in hist], dtype=np.float32))
            # only KNOWN users contribute to a new item's row; the
            # unknown ones get their own row solved below, against a
            # table that already includes this item
            known = [(int(uu), float(vv)) for uu, vv in zip(u, v)
                     if uu >= 0]
            item_rows.append((ikey, known))
        keys, solved = _solve_side(model, "item", item_rows, max_history)
        model = extend_factor_rows(model, "item", keys, solved)
        report.items_inserted = len(keys)
        G = None  # the item table changed: a cached Gramian is stale
    if model.params.implicit_prefs and G is None:
        G = fixed_gramian(model.item_factors, model.params)

    # -- user rows: existing fold-in + cold-start insertion --------------
    user_rows: List[Tuple[str, List[Tuple[int, float]]]] = []
    for ukey in touched_users:
        hist = project_ratings(
            _entity_history(storage, app_id, channel_id, ukey,
                            event_names), weights)
        items = np.array([model.item_ids.get(ii, -1) if model.item_ids
                          else -1 for _, ii, _ in hist], dtype=np.int64)
        vals = np.array([vv for _, _, vv in hist], dtype=np.float32)
        rows_u = np.zeros(len(hist), dtype=np.int64)
        _, items_d, vals_d = dedupe_pairs(rows_u, items, vals)
        known = [(int(ii), float(vv)) for ii, vv in zip(items_d, vals_d)
                 if ii >= 0]
        user_rows.append((ukey, known))
    keys, solved = _solve_side(model, "user", user_rows, max_history, G=G)
    existing_idx, existing_rows = [], []
    new_keys, new_rows = [], []
    for k, row in zip(keys, solved):
        uidx = model.user_ids.get(k) if model.user_ids else None
        if uidx is None:
            new_keys.append(k)
            new_rows.append(row)
        else:
            existing_idx.append(int(uidx))
            existing_rows.append(row)
    if existing_idx:
        model = apply_row_updates(model, "user",
                                  np.asarray(existing_idx),
                                  np.asarray(existing_rows))
        report.users_updated = len(existing_idx)
    if new_keys:
        model = extend_factor_rows(model, "user", new_keys,
                                   np.asarray(new_rows))
        report.users_inserted = len(new_keys)

    report.residual = _batch_residual(model, triples)
    return model, report


def _host_rows(table, rows: List[int]) -> np.ndarray:
    """Host f32 copies of a table's ``rows``, dequantized: what the table
    serves (a row-sharded table's from their owner shards)."""
    return table_rows_f32(table, rows)


def _batch_residual(model: ALSModel, triples) -> Optional[float]:
    """Mean |u.v - r| over the batch, normalized by max(1, |r|): how well
    the folded rows explain the very events they folded. For implicit
    models the target is preference 1 on observed entries."""
    pairs = []
    for ukey, ikey, r in triples:
        ui = model.user_ids.get(ukey) if model.user_ids else None
        ii = model.item_ids.get(ikey) if model.item_ids else None
        if ui is not None and ii is not None:
            pairs.append((int(ui), int(ii), r))
    if not pairs:
        return None
    U = _host_rows(model.user_factors, [u for u, _, _ in pairs])
    V = _host_rows(model.item_factors, [i for _, i, _ in pairs])
    errs = []
    for k, (_, _, r) in enumerate(pairs):
        pred = float(U[k] @ V[k])
        target = 1.0 if model.params.implicit_prefs else float(r)
        errs.append(abs(pred - target) / max(1.0, abs(target)))
    return float(np.mean(errs))
