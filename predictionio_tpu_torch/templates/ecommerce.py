"""E-commerce recommendation template (the port of
``predictionio_tpu/templates/ecommerce.py``): implicit ALS over
deduplicated view counts, a buy-count popularity fallback, serving-time
filters read from the event store, and weighted score adjustment.

Training runs the port's ``train_als`` with implicit preferences on the
context's device (the card unless it names the CPU) or over its mesh,
as the recommendation template does: every half-step
goes through ``fused_gram`` with the implicit weights and the fixed
side's Gramian, then ``chol_solve``. The factors come back to the host,
and ``predict`` scores in host numpy, as the JAX package does: a known
user by factor dot products, an unknown user with recent views by
cosine similarity to those items, anyone else by popularity. The
serving-time reads (seen items, the ``unavailableItems`` and
``weightedItems`` constraints, recent views) are point reads with a
deadline that degrade to an empty set on failure.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import logging

import numpy as np

from ..controller import (
    Algorithm,
    Context,
    DataSource,
    Engine,
    EngineParams,
    FirstServing,
    IdentityPreparator,
    SanityCheck,
)
from ..data.bimap import BiMap
from ..models.als import ALSParams, RatingsCOO
from ..workflow.persistence import bimap_json, ids_json, register_kind
from ._common import (
    candidate_mask,
    dedup_view_ratings,
    items_from_json,
    items_json,
    top_scores,
    train_als_on,
)

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class Query:
    user: str
    num: int = 10
    categories: Optional[Tuple[str, ...]] = None
    white_list: Optional[Tuple[str, ...]] = None
    black_list: Optional[Tuple[str, ...]] = None

    def __init__(self, user, num=10, categories=None, white_list=None,
                 black_list=None):
        conv = lambda v: tuple(v) if v is not None else None
        object.__setattr__(self, "user", user)
        object.__setattr__(self, "num", num)
        object.__setattr__(self, "categories", conv(categories))
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
class UserItemEvent:
    user: str
    item: str
    t: float


@dataclass
class TrainingData(SanityCheck):
    users: Dict[str, dict]
    items: Dict[str, Item]
    view_events: List[UserItemEvent]
    buy_events: List[UserItemEvent]

    def sanity_check(self):
        if not self.users or not self.items:
            raise ValueError("users/items cannot be empty")


@dataclass(frozen=True)
class DataSourceParams:
    app_name: str = ""


class ECommerceDataSource(DataSource):
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
        views, buys = [], []
        for e in ctx.event_store.find(
                app, entity_type="user", event_names=["view", "buy"],
                target_entity_type="item"):
            ev = UserItemEvent(e.entity_id, e.target_entity_id,
                               e.event_time.timestamp())
            (views if e.event == "view" else buys).append(ev)
        return TrainingData(users, items, views, buys)


@dataclass(frozen=True)
class ECommAlgorithmParams:
    """``ECommAlgorithmParams`` (``ECommAlgorithm.scala:38-47``)."""
    app_name: str = ""
    unseen_only: bool = False
    seen_events: Tuple[str, ...] = ("buy", "view")
    similar_events: Tuple[str, ...] = ("view",)
    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    seed: Optional[int] = None
    #: serving-time event-store read deadline (reference: 200ms Duration)
    timeout_ms: int = 200


@dataclass
class ECommModel:
    #: app the model was trained from — fallback for serving-time reads
    #: when ``ECommAlgorithmParams.app_name`` is unset
    app_name: str
    rank: int
    user_factors: np.ndarray   # [U, rank]
    has_user: np.ndarray       # [U] bool — user appeared in training
    item_factors: np.ndarray   # [I, rank]
    has_item: np.ndarray       # [I] bool — item has a trained vector
    popular_count: np.ndarray  # [I] buy counts
    user_ids: BiMap
    item_ids: BiMap
    items: Dict[int, Item]


_ECOMM_ARRAYS = ("user_factors", "has_user", "item_factors", "has_item",
                 "popular_count")


def _encode_ecomm(m: ECommModel) -> Tuple[Dict[str, np.ndarray], dict]:
    return ({k: getattr(m, k) for k in _ECOMM_ARRAYS},
            {"app_name": m.app_name, "rank": m.rank,
             "user_ids": ids_json(m.user_ids),
             "item_ids": ids_json(m.item_ids), "items": items_json(m.items)})


def _decode_ecomm(arrays: Dict[str, np.ndarray], m: dict) -> ECommModel:
    return ECommModel(
        app_name=m["app_name"], rank=m["rank"],
        **{k: arrays[k] for k in _ECOMM_ARRAYS},
        user_ids=bimap_json(m["user_ids"]),
        item_ids=bimap_json(m["item_ids"]),
        items=items_from_json(m["items"], Item))


register_kind("ECommModel", ECommModel, _encode_ecomm, _decode_ecomm)


class ECommAlgorithm(Algorithm):
    query_class = Query

    def __init__(self, params: ECommAlgorithmParams = ECommAlgorithmParams()):
        self.params = params

    # -- training ------------------------------------------------------------
    def gen_ratings(self, td: TrainingData, user_ids: BiMap,
                    item_ids: BiMap) -> RatingsCOO:
        """Deduped view counts (``genMLlibRating`` :171-204)."""
        return dedup_view_ratings(td.view_events, user_ids, item_ids)

    def train_default(self, td: TrainingData, user_ids: BiMap,
                      item_ids: BiMap) -> np.ndarray:
        """Buy-count popularity (``trainDefault`` :206-240)."""
        counts = np.zeros(len(item_ids), dtype=np.int64)
        for b in td.buy_events:
            if b.user in user_ids and b.item in item_ids:
                counts[item_ids[b.item]] += 1
        return counts

    def train(self, ctx: Context, td: TrainingData) -> ECommModel:
        if not td.view_events:
            raise ValueError("viewEvents cannot be empty")
        self._serving_store = ctx.event_store
        user_ids = BiMap.string_int(td.users.keys())
        item_ids = BiMap.string_int(td.items.keys())
        ratings = self.gen_ratings(td, user_ids, item_ids)
        p = self.params
        als = ALSParams(rank=p.rank, num_iterations=p.num_iterations,
                        reg=p.lambda_, implicit_prefs=True, alpha=1.0,
                        seed=p.seed if p.seed is not None else 0)
        U, V = train_als_on(ctx, ratings, als)
        U = U.cpu().numpy()[:len(user_ids)]
        V = V.cpu().numpy()[:len(item_ids)]
        has_user = np.zeros(len(user_ids), dtype=bool)
        has_user[np.unique(ratings.users)] = True
        has_item = np.zeros(len(item_ids), dtype=bool)
        has_item[np.unique(ratings.items)] = True
        return ECommModel(
            app_name=p.app_name or ctx.app_name,
            rank=p.rank, user_factors=U, has_user=has_user,
            item_factors=V, has_item=has_item,
            popular_count=self.train_default(td, user_ids, item_ids),
            user_ids=user_ids, item_ids=item_ids,
            items={item_ids[k]: v for k, v in td.items.items()})

    # -- serving-time event-store lookups -------------------------------------
    def bind_serving(self, ctx: Context) -> None:
        # capture the serving Context's storage so filter reads
        # (seen/unavailable/weighted/recent) hit the same backend the model
        # was deployed against, not the process-global default
        self._serving_store = ctx.event_store

    def bind_feature_cache(self, cache) -> None:
        """Serving-time filter reads go through ``cache`` (an object with
        ``lookup(key) -> (found, value)`` and ``put(key, value, tags)``):
        a hot user's seen and recent sets and the app-wide constraint
        reads stop hitting storage once a query. Entries are tagged with
        the entity they derive from, so an invalidation can clear them
        when a contradicting event arrives. The engine server hands its
        feature tier here at every bind when deployed with the serving
        cache; without one, reads go through."""
        self._feature_cache = cache

    def _ctx_store(self):
        store = getattr(self, "_serving_store", None)
        if store is not None:
            return store
        from ..data.store import event_store
        return event_store

    def _cached_read(self, key: tuple, tags: Tuple[str, ...], fn):
        cache = getattr(self, "_feature_cache", None)
        if cache is None:
            return fn()
        found, value = cache.lookup(key)
        if found:
            return value
        value = fn()
        cache.put(key, value, tags=tags)
        return value

    def gen_black_list(self, query: Query, app_name: str) -> Set[str]:
        """query.blackList + seen items + unavailableItems constraint
        (``genBlackList`` :329-396). Event-store failures degrade to empty
        sets — serving never hard-fails on a filter read."""
        p = self.params
        seen: Set[str] = set()
        if p.unseen_only:
            def read_seen() -> Set[str]:
                out: Set[str] = set()
                try:
                    for e in self._ctx_store().find_by_entity(
                            app_name, "user", query.user,
                            event_names=list(p.seen_events),
                            target_entity_type="item",
                            timeout_ms=p.timeout_ms):
                        if e.target_entity_id:
                            out.add(e.target_entity_id)
                except Exception as err:
                    log.error("error reading seen events: %s", err)
                return out

            seen = self._cached_read(
                ("ecomm-seen", app_name, query.user, p.seen_events),
                (f"user:{query.user}",), read_seen)

        def read_unavailable() -> Set[str]:
            try:
                evs = self._ctx_store().find_by_entity(
                    app_name, "constraint", "unavailableItems",
                    event_names=["$set"], limit=1, latest=True,
                    timeout_ms=p.timeout_ms)
                if evs:
                    return set(evs[0].properties.get("items") or ())
            except Exception as err:
                log.error("error reading unavailableItems: %s", err)
            return set()

        unavailable = self._cached_read(
            ("ecomm-unavailable", app_name),
            ("constraint:unavailableItems",), read_unavailable)
        return set(query.black_list or ()) | seen | unavailable

    def weighted_items(self, app_name: str) -> List[Tuple[Set[str], float]]:
        """Latest ``weightedItems`` constraint → weight groups
        (``weightedItems`` :399-425)."""
        p = self.params

        def read_weighted() -> List[Tuple[Set[str], float]]:
            try:
                evs = self._ctx_store().find_by_entity(
                    app_name, "constraint", "weightedItems",
                    event_names=["$set"], limit=1, latest=True,
                    timeout_ms=p.timeout_ms)
                if evs:
                    return [(set(g["items"]), float(g["weight"]))
                            for g in (evs[0].properties.get("weights")
                                      or ())]
            except Exception as err:
                log.error("error reading weightedItems: %s", err)
            return []

        return self._cached_read(("ecomm-weighted", app_name),
                                 ("constraint:weightedItems",),
                                 read_weighted)

    def get_recent_items(self, query: Query, app_name: str) -> Set[str]:
        """Latest 10 similar-events targets (``getRecentItems`` :427-462)."""
        p = self.params

        def read_recent() -> Set[str]:
            try:
                return {e.target_entity_id for e in self._ctx_store()
                        .find_by_entity(
                            app_name, "user", query.user,
                            event_names=list(p.similar_events),
                            target_entity_type="item", limit=10,
                            latest=True, timeout_ms=p.timeout_ms)
                        if e.target_entity_id}
            except Exception as err:
                log.error("error reading recent events: %s", err)
                return set()

        return self._cached_read(
            ("ecomm-recent", app_name, query.user, p.similar_events),
            (f"user:{query.user}",), read_recent)

    # -- predict ---------------------------------------------------------------
    def _weights_vector(self, model: ECommModel,
                        app_name: str) -> np.ndarray:
        """The per-item weight vector, built once per (model, app_name,
        weight groups): the groups change only when a new
        ``weightedItems`` ``$set`` lands, so the vector is memoized
        against their content and a weak reference to the model (a new
        model has a new item index space)."""
        import weakref

        groups = self.weighted_items(app_name)
        sig = tuple(sorted((weight, tuple(sorted(items)))
                           for items, weight in groups))
        memo = getattr(self, "_weights_memo", None)
        if (memo is not None and memo[0]() is model
                and memo[1] == app_name and memo[2] == sig):
            return memo[3]
        w = np.ones(len(model.item_ids), dtype=np.float64)
        for items, weight in groups:
            idx = [model.item_ids[it] for it in items
                   if it in model.item_ids]
            if idx:
                w[idx] = weight
        self._weights_memo = (weakref.ref(model), app_name, sig, w)
        return w

    def predict(self, model: ECommModel, query: Query) -> PredictedResult:
        app_name = self.params.app_name or model.app_name
        black = self.gen_black_list(query, app_name)
        weights = self._weights_vector(model, app_name)
        mask = candidate_mask(
            model.items, len(model.item_ids), model.item_ids,
            white_list=query.white_list, black_list=black,
            categories=query.categories)

        uidx = model.user_ids.get(query.user)
        if uidx is not None and model.has_user[uidx]:
            # known user: dot(userFeature, itemFeature) × weight (:469-504)
            scores = (model.item_factors @ model.user_factors[uidx]) * weights
            scores[~model.has_item] = 0.0
            top = top_scores(scores, mask, query.num, positive_only=True)
        else:
            recent = {model.item_ids[i]
                      for i in self.get_recent_items(query, app_name)
                      if i in model.item_ids}
            recent_f = [model.item_factors[i] for i in recent
                        if model.has_item[i]]
            if recent_f:
                # cosine-similar to recent items (:539-576)
                R = np.stack(recent_f)
                Rn = R / np.maximum(
                    np.linalg.norm(R, axis=1, keepdims=True), 1e-12)
                V = model.item_factors
                Vn = V / np.maximum(
                    np.linalg.norm(V, axis=1, keepdims=True), 1e-12)
                scores = (Rn @ Vn.T).sum(axis=0) * weights
                scores[~model.has_item] = 0.0
                top = top_scores(scores, mask, query.num, positive_only=True)
            else:
                # popularity fallback (:506-537); no positive-score filter
                scores = model.popular_count.astype(np.float64) * weights
                top = top_scores(scores, mask, query.num, positive_only=False)

        inv = model.item_ids.inverse
        return PredictedResult(tuple(
            ItemScore(inv[i], s) for i, s in top))


def ecommerce_engine() -> Engine:
    return Engine(
        datasource_classes=ECommerceDataSource,
        preparator_classes=IdentityPreparator,
        algorithm_classes={"ecomm": ECommAlgorithm, "": ECommAlgorithm},
        serving_classes=FirstServing,
        datasource_params_class=DataSourceParams,
        algorithm_params_classes={"ecomm": ECommAlgorithmParams,
                                  "": ECommAlgorithmParams},
    )


def default_engine_params(app_name: str, **algo_kw) -> EngineParams:
    return EngineParams(
        datasource=("", DataSourceParams(app_name=app_name)),
        algorithms=[("ecomm", ECommAlgorithmParams(app_name=app_name,
                                                   **algo_kw))],
    )
