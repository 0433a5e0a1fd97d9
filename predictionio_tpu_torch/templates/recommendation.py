"""Recommendation engine template: the port of
``predictionio_tpu/templates/recommendation.py`` (training and serving).

Training reads ``rate``/``buy`` events of an app from the event store
(:class:`RecommendationDataSource`, the default) or takes a
:class:`TrainingData` from the caller's own ``DataSource``, passes it
through :class:`IdentityPreparator`, and trains an ALS model on the
context's device. Queries and results use the JSON shapes of the JAX
package's engine server::

    POST /queries.json  {"user": "1", "num": 4, "blackList": ["22"]}
    -> {"itemScores": [{"item": "7", "score": 4.07}, ...]}

Left out (``ROADMAP.md`` queue 1): ``read_eval`` and the eval metrics,
``ExcludeItemsPreparator`` and the file-blacklist serving.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..controller.base import (
    Algorithm,
    DataSource,
    FirstServing,
    IdentityPreparator,
    SanityCheck,
)
from ..controller.context import Context
from ..controller.engine import ClassMap, Engine
from ..models.als import (
    ALSModel,
    ALSParams,
    RatingsCOO,
    pack_ratings_cached,
    place_model,
    quantize_serving_model,
    recommend_batch_async,
    recommend_products,
    train_als,
)
from ..models.data import ratings_from_columnar


@dataclass(frozen=True)
class Query:
    """One query; ``black_list`` items are never returned."""
    user: str
    num: int = 10
    black_list: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if self.black_list is not None:
            object.__setattr__(self, "black_list", tuple(self.black_list))


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


@dataclass
class TrainingData(SanityCheck):
    """Rating triples with the id maps from entity ids to their rows."""

    ratings: RatingsCOO
    user_ids: object  # BiMap
    item_ids: object  # BiMap

    def sanity_check(self):
        if self.ratings.users.size == 0:
            raise ValueError("TrainingData has no ratings; check that "
                             "rate/buy events exist for the app")


@dataclass(frozen=True)
class DataSourceParams:
    """Where the training events live and how they become ratings. The
    eval fields are accepted, so a JAX package variant parses unchanged,
    but eval is not ported."""
    app_name: str = ""
    channel_name: Optional[str] = None
    eval_k: int = 0
    eval_query_num: int = 10
    eval_rating_threshold: float = 2.0
    seed: int = 3
    #: event name -> fixed rating (None: read the ``rating`` property);
    #: None means ``{"rate": None, "buy": 4.0}``
    event_weights: Optional[Dict[str, Optional[float]]] = None


class RecommendationDataSource(DataSource):
    """Reads an app's rating events from the event store as columns."""

    def __init__(self, params: DataSourceParams = DataSourceParams()):
        self.params = params

    def read_training(self, ctx: Context) -> TrainingData:
        weights = self.params.event_weights
        batch = ctx.event_store.find_columnar(
            self.params.app_name or ctx.app_name,
            channel_name=self.params.channel_name,
            entity_type="user", target_entity_type="item",
            event_names=(list(weights) if weights is not None
                         else ["rate", "buy"]),
            # a bulk COO build needs neither time order nor raw JSON
            ordered=False, with_props=False)
        ratings, user_ids, item_ids = ratings_from_columnar(
            batch, event_weights=weights)
        return TrainingData(ratings, user_ids, item_ids)


def query_from_json(obj: dict) -> Query:
    return Query(user=str(obj["user"]), num=int(obj.get("num", 10)))


def _black_ids(model: ALSModel, query: Query) -> set:
    return {model.item_ids[i] for i in (query.black_list or ())
            if i in model.item_ids}


def _pick(model: ALSModel, query: Query, ids, scores) -> PredictedResult:
    """Drop blacklisted items from an over-fetched ranking and keep the
    first ``num`` (the blacklist variant's filter)."""
    black = _black_ids(model, query)
    inv = model.item_ids.inverse
    picked = [(int(i), float(s)) for i, s in zip(ids, scores)
              if int(i) not in black][: query.num]
    return PredictedResult(tuple(ItemScore(item=inv[i], score=s)
                                 for i, s in picked))


class ALSAlgorithm(Algorithm):
    """Serves a trained explicit- or implicit-feedback ALS model."""

    query_class = Query

    def __init__(self, params: ALSParams = ALSParams()):
        self.params = params

    def train(self, ctx: Context, td: TrainingData) -> ALSModel:
        """Pack once per ratings object and train on ``ctx.device``. On
        the card, returns only once the queued iterations have run, so
        the engine's stage clock covers them."""
        packed = pack_ratings_cached(td.ratings, self.params,
                                     device=ctx.device)
        U, V = train_als(td.ratings, self.params, device=ctx.device,
                         packed=packed)
        if U.is_cuda:
            torch.cuda.synchronize(U.device)
        return ALSModel(user_factors=U, item_factors=V,
                        n_users=td.ratings.n_users,
                        n_items=td.ratings.n_items,
                        user_ids=td.user_ids, item_ids=td.item_ids,
                        params=self.params)

    def predict(self, model: ALSModel, query: Query) -> PredictedResult:
        uidx = model.user_ids.get(query.user) if model.user_ids else None
        if uidx is None:
            return PredictedResult()  # unknown user: empty result
        # over-fetch by the blacklist size, then filter
        ids, scores = recommend_products(
            model, int(uidx), query.num + len(_black_ids(model, query)))
        return _pick(model, query, ids, scores)

    def prepare_serving_model(self, model: ALSModel,
                              device: torch.device) -> ALSModel:
        """Place both factor tables on ``device`` once, at bind."""
        return place_model(model, device)

    def quantize_serving_model(self, model: ALSModel,
                               quant: str) -> ALSModel:
        """Row-quantize the serving tables behind the NDCG@10 parity
        probe (auto-off keeps f32 where the ranking would suffer)."""
        return quantize_serving_model(model, quant)

    def batch_predict_async(self, model: ALSModel, queries: Sequence[Query]
                            ) -> Callable[[], List[PredictedResult]]:
        """Launch one batched top-k for every known user and return a
        resolver that waits for it and builds the per-query results.
        Each query over-fetches by the longest blacklist in the batch."""
        known = [(qi, int(model.user_ids[q.user])) for qi, q in
                 enumerate(queries) if model.user_ids
                 and q.user in model.user_ids]
        out: List[PredictedResult] = [PredictedResult()] * len(queries)
        if not known:
            return lambda: out
        max_black = max((len(q.black_list or ()) for q in queries),
                        default=0)
        num = max(q.num for q in queries) + max_black
        idx = np.array([u for _, u in known], dtype=np.int64)
        handle = recommend_batch_async(model, idx, num)

        def resolve() -> List[PredictedResult]:
            ids, scores = handle()
            for row, (qi, _) in enumerate(known):
                out[qi] = _pick(model, queries[qi], ids[row], scores[row])
            return out

        return resolve

    def batch_predict(self, model: ALSModel, queries: Sequence[Query]
                      ) -> List[PredictedResult]:
        """One batched dispatch and an immediate readback."""
        return self.batch_predict_async(model, queries)()


class RecommendationServing(FirstServing):
    pass


def recommendation_engine(datasource_classes: Optional[ClassMap] = None
                          ) -> Engine:
    """Engine factory of the template. The data source is
    :class:`RecommendationDataSource` over the event store, unless
    ``datasource_classes`` names the caller's own (yielding
    :class:`TrainingData`; its params then pass through as a dict)."""
    own = datasource_classes is not None
    return Engine(
        algorithm_classes={"als": ALSAlgorithm, "": ALSAlgorithm},
        serving_classes={"": RecommendationServing},
        algorithm_params_classes={"als": ALSParams, "": ALSParams},
        datasource_classes=(datasource_classes if own
                            else RecommendationDataSource),
        datasource_params_class=None if own else DataSourceParams,
        preparator_classes={"": IdentityPreparator},
    )
