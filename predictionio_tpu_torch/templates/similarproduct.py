"""Similar-product engine template, multi-events and multi-algorithms
(the port of ``predictionio_tpu/templates/similarproduct.py``).

The data source reads user and item entities plus ``view`` and
``like``/``dislike`` events. Three algorithms: implicit ALS over view
counts scored by summed item-factor cosine, co-occurrence counting, and
implicit ALS over the latest like (+1) or dislike (-1) per (user,
item). A z-score serving standardizes each algorithm's scores and sums
them per item.

Both ALS variants train through the port's ``train_als`` on the
context's device (the card unless it names the CPU) or over its mesh,
as the recommendation template does, so every half-step
runs ``fused_gram`` and ``chol_solve``; co-occurrence runs ``AᵀA`` there
(``models/cooccurrence.py``). ``predict`` scores in host numpy, as the
JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np

from ..controller import (
    Algorithm,
    Context,
    DataSource,
    Engine,
    IdentityPreparator,
    SanityCheck,
    Serving,
)
from ..data.bimap import BiMap
from ..models.als import ALSParams, RatingsCOO
from ..models.cooccurrence import CooccurrenceModel, train_cooccurrence
from ..workflow.persistence import bimap_json, ids_json, register_kind
from ._common import (
    candidate_mask,
    dedup_view_ratings,
    items_from_json,
    items_json,
    top_scores,
    train_als_on,
)


# -- query / result -----------------------------------------------------------

@dataclass(frozen=True)
class Query:
    items: Tuple[str, ...]
    num: int = 10
    categories: Optional[Tuple[str, ...]] = None
    category_black_list: Optional[Tuple[str, ...]] = None
    white_list: Optional[Tuple[str, ...]] = None
    black_list: Optional[Tuple[str, ...]] = None

    def __init__(self, items, num=10, categories=None,
                 category_black_list=None, white_list=None, black_list=None):
        conv = lambda v: tuple(v) if v is not None else None
        object.__setattr__(self, "items", tuple(items))
        object.__setattr__(self, "num", num)
        object.__setattr__(self, "categories", conv(categories))
        object.__setattr__(self, "category_black_list",
                           conv(category_black_list))
        object.__setattr__(self, "white_list", conv(white_list))
        object.__setattr__(self, "black_list", conv(black_list))


@dataclass(frozen=True)
class ItemScore:
    item: str
    score: float


@dataclass(frozen=True)
class PredictedResult:
    item_scores: Tuple[ItemScore, ...] = ()

    def to_json(self) -> dict:
        return {"itemScores": [{"item": s.item, "score": s.score}
                               for s in self.item_scores]}


@dataclass(frozen=True)
class Item:
    categories: Optional[Tuple[str, ...]] = None


@dataclass(frozen=True)
class ViewEvent:
    user: str
    item: str
    t: float


@dataclass(frozen=True)
class LikeEvent:
    user: str
    item: str
    t: float
    like: bool


@dataclass
class TrainingData(SanityCheck):
    users: Dict[str, dict]
    items: Dict[str, Item]
    view_events: List[ViewEvent]
    like_events: List[LikeEvent]

    def sanity_check(self):
        if not self.users or not self.items:
            raise ValueError("users/items cannot be empty")


@dataclass(frozen=True)
class DataSourceParams:
    app_name: str = ""


class SimilarProductDataSource(DataSource):
    """``DataSource.scala:36-140``."""

    def __init__(self, params: DataSourceParams = DataSourceParams()):
        self.params = params

    def read_training(self, ctx: Context) -> TrainingData:
        app = self.params.app_name or ctx.app_name
        users = {eid: {} for eid in
                 ctx.event_store.aggregate_properties(app, "user")}
        items = {}
        for eid, pm in ctx.event_store.aggregate_properties(
                app, "item").items():
            cats = pm.get("categories")
            items[eid] = Item(categories=tuple(cats) if cats else None)
        views, likes = [], []
        for e in ctx.event_store.find(
                app, entity_type="user", event_names=["view"],
                target_entity_type="item"):
            views.append(ViewEvent(e.entity_id, e.target_entity_id,
                                   e.event_time.timestamp()))
        for e in ctx.event_store.find(
                app, entity_type="user", event_names=["like", "dislike"],
                target_entity_type="item"):
            likes.append(LikeEvent(e.entity_id, e.target_entity_id,
                                   e.event_time.timestamp(),
                                   like=(e.event == "like")))
        return TrainingData(users, items, views, likes)


# -- shared model: item factors + metadata -----------------------------------

@dataclass
class SPModel:
    item_factors: np.ndarray          # [I, rank]; rows may be all-zero
    has_factors: np.ndarray           # [I] bool
    item_ids: BiMap
    items: Dict[int, Item]


class SPCooccurrenceModel(NamedTuple):
    """What the co-occurrence algorithm trains: the neighbour table with
    its item ids and the items' categories."""
    cooc: CooccurrenceModel
    item_ids: BiMap
    items: Dict[int, Item]


def _encode_sp(m: SPModel) -> Tuple[Dict[str, np.ndarray], dict]:
    return ({"item_factors": m.item_factors, "has_factors": m.has_factors},
            {"item_ids": ids_json(m.item_ids), "items": items_json(m.items)})


def _decode_sp(arrays: Dict[str, np.ndarray], m: dict) -> SPModel:
    return SPModel(arrays["item_factors"], arrays["has_factors"],
                   bimap_json(m["item_ids"]),
                   items_from_json(m["items"], Item))


def _encode_cooc(m: SPCooccurrenceModel
                 ) -> Tuple[Dict[str, np.ndarray], dict]:
    return ({"indices": m.cooc.indices, "counts": m.cooc.counts},
            {"n_items": m.cooc.n_items, "n": m.cooc.n,
             "item_ids": ids_json(m.item_ids), "items": items_json(m.items)})


def _decode_cooc(arrays: Dict[str, np.ndarray],
                 m: dict) -> SPCooccurrenceModel:
    return SPCooccurrenceModel(
        CooccurrenceModel(arrays["indices"], arrays["counts"], m["n_items"],
                          m["n"]),
        bimap_json(m["item_ids"]), items_from_json(m["items"], Item))


register_kind("SPModel", SPModel, _encode_sp, _decode_sp)
register_kind("CooccurrenceModel", SPCooccurrenceModel, _encode_cooc,
              _decode_cooc)


def _query_mask(model_items: Dict[int, Item], n_items: int,
                query_idx: Set[int], query: Query,
                item_ids: BiMap) -> np.ndarray:
    """Candidate filter (``CooccurrenceAlgorithm.isCandidateItem``
    :153-173 + the ALS variant's categoryBlackList); query items are
    always excluded."""
    return candidate_mask(
        model_items, n_items, item_ids,
        white_list=query.white_list, black_list=query.black_list or (),
        exclude_idx=query_idx, categories=query.categories,
        category_black_list=query.category_black_list)


class SPALSAlgorithm(Algorithm):
    """Implicit ALS on deduped view counts; predict = summed cosine
    between query items' factors and every item (``ALSAlgorithm.scala``)."""

    query_class = Query

    def __init__(self, params: ALSParams = ALSParams(
            rank=10, num_iterations=20, reg=0.01,
            implicit_prefs=True, alpha=1.0)):
        self.params = params

    def _check(self, td: TrainingData) -> None:
        if not td.view_events:
            raise ValueError("viewEvents cannot be empty")

    def _ratings(self, td: TrainingData, user_ids: BiMap,
                 item_ids: BiMap) -> RatingsCOO:
        return dedup_view_ratings(td.view_events, user_ids, item_ids)

    def train(self, ctx: Context, td: TrainingData) -> SPModel:
        self._check(td)
        user_ids = BiMap.string_int(td.users.keys())
        item_ids = BiMap.string_int(td.items.keys())
        ratings = self._ratings(td, user_ids, item_ids)
        _, V = train_als_on(ctx, ratings, self.params)
        V = V.cpu().numpy()[:len(item_ids)]
        has = np.zeros(len(item_ids), dtype=bool)
        has[np.unique(ratings.items)] = True
        items = {item_ids[k]: v for k, v in td.items.items()}
        return SPModel(V, has, item_ids, items)

    def predict(self, model: SPModel, query: Query) -> PredictedResult:
        query_idx = {model.item_ids[i] for i in query.items
                     if i in model.item_ids}
        qf = [model.item_factors[i] for i in query_idx
              if model.has_factors[i]]
        if not qf:
            return PredictedResult()
        # summed cosine = (normalized query factors) @ (normalized factors)ᵀ
        Q = np.stack(qf)
        Qn = Q / np.maximum(np.linalg.norm(Q, axis=1, keepdims=True), 1e-12)
        V = model.item_factors
        Vn = V / np.maximum(np.linalg.norm(V, axis=1, keepdims=True), 1e-12)
        scores = Qn @ Vn.T
        scores = scores.sum(axis=0)
        scores[~model.has_factors] = 0.0
        mask = _query_mask(model.items, len(scores), query_idx, query,
                           model.item_ids)
        inv = model.item_ids.inverse
        return PredictedResult(tuple(
            ItemScore(inv[i], s)
            for i, s in top_scores(scores, mask, query.num)))


class SPLikeAlgorithm(SPALSAlgorithm):
    """±1 ratings from the LATEST like/dislike per (user, item)
    (``LikeAlgorithm.scala:59-95``); training flow shared with the ALS
    base, only the ratings construction differs."""

    def _check(self, td: TrainingData) -> None:
        if not td.like_events:
            raise ValueError("likeEvents cannot be empty")

    def _ratings(self, td: TrainingData, user_ids: BiMap,
                 item_ids: BiMap) -> RatingsCOO:
        latest: Dict[Tuple[int, int], Tuple[float, bool]] = {}
        for ev in td.like_events:
            u, i = user_ids.get(ev.user), item_ids.get(ev.item)
            if u is None or i is None:
                continue
            cur = latest.get((u, i))
            if cur is None or ev.t > cur[0]:
                latest[(u, i)] = (ev.t, ev.like)
        if not latest:
            raise ValueError("likeEvents cannot be empty")
        keys = np.array(list(latest.keys()), dtype=np.int32)
        vals = np.array([1.0 if like else -1.0
                         for _, like in latest.values()], dtype=np.float32)
        return RatingsCOO(users=keys[:, 0], items=keys[:, 1], ratings=vals,
                          n_users=len(user_ids), n_items=len(item_ids))


@dataclass(frozen=True)
class CooccurrenceParams:
    n: int = 20


class SPCooccurrenceAlgorithm(Algorithm):
    """``CooccurrenceAlgorithm.scala:45-160``."""

    query_class = Query

    def __init__(self, params: CooccurrenceParams = CooccurrenceParams()):
        self.params = params

    def train(self, ctx: Context, td: TrainingData) -> SPCooccurrenceModel:
        item_ids = BiMap.string_int(td.items.keys())
        user_ids = BiMap.string_int(td.users.keys())
        pairs = [(user_ids[v.user], item_ids[v.item]) for v in td.view_events
                 if v.user in user_ids and v.item in item_ids]
        if not pairs:
            raise ValueError("no valid view events")
        arr = np.array(pairs, dtype=np.int64)
        model = train_cooccurrence(arr[:, 0], arr[:, 1],
                                   len(user_ids), len(item_ids),
                                   self.params.n, device=ctx.device)
        items = {item_ids[k]: v for k, v in td.items.items()}
        return SPCooccurrenceModel(model, item_ids, items)

    def predict(self, model, query: Query) -> PredictedResult:
        cooc, item_ids, items = model
        query_idx = {item_ids[i] for i in query.items if i in item_ids}
        scored = cooc.score_items(sorted(query_idx))
        scores = np.zeros(cooc.n_items)
        for i, c in scored.items():
            scores[i] = c
        mask = _query_mask(items, cooc.n_items, query_idx, query, item_ids)
        inv = item_ids.inverse
        return PredictedResult(tuple(
            ItemScore(inv[i], s)
            for i, s in top_scores(scores, mask, query.num)))


class SimilarProductServing(Serving):
    """z-score standardize each algorithm's scores (skipped when num==1),
    then sum per item (``Serving.scala:26-70``)."""

    def serve(self, query: Query,
              predictions: Sequence[PredictedResult]) -> PredictedResult:
        if query.num == 1:
            standardized = [p.item_scores for p in predictions]
        else:
            standardized = []
            for p in predictions:
                vals = np.array([s.score for s in p.item_scores])
                if vals.size and vals.std() > 0:
                    mean, std = vals.mean(), vals.std(ddof=1)
                else:
                    mean, std = 0.0, 0.0
                standardized.append(tuple(
                    ItemScore(s.item,
                              0.0 if std == 0
                              else (s.score - mean) / std)
                    for s in p.item_scores))
        combined: Dict[str, float] = {}
        for group in standardized:
            for s in group:
                combined[s.item] = combined.get(s.item, 0.0) + s.score
        top = sorted(combined.items(), key=lambda kv: -kv[1])[:query.num]
        return PredictedResult(tuple(ItemScore(i, v) for i, v in top))


def similarproduct_engine() -> Engine:
    """``SimilarProductEngine`` factory (``Engine.scala:43-54``)."""
    return Engine(
        datasource_classes=SimilarProductDataSource,
        preparator_classes=IdentityPreparator,
        algorithm_classes={"als": SPALSAlgorithm,
                           "cooccurrence": SPCooccurrenceAlgorithm,
                           "likealgo": SPLikeAlgorithm,
                           "": SPALSAlgorithm},
        serving_classes=SimilarProductServing,
        datasource_params_class=DataSourceParams,
        algorithm_params_classes={"als": ALSParams,
                                  "cooccurrence": CooccurrenceParams,
                                  "likealgo": ALSParams,
                                  "": ALSParams},
    )
