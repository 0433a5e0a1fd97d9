"""Recommendation engine template: the port of
``predictionio_tpu/templates/recommendation.py``.

Training reads ``rate``/``buy`` events of an app from the event store
(:class:`RecommendationDataSource`, the default) or takes a
:class:`TrainingData` from the caller's own ``DataSource``, passes it
through a preparator (identity, or :class:`ExcludeItemsPreparator`),
and trains an ALS model on the context's device. Queries and results use
the JSON shapes of the JAX package's engine server::

    POST /queries.json  {"user": "1", "num": 4, "blackList": ["22"]}
    -> {"itemScores": [{"item": "7", "score": 4.07}, ...]}

Evaluation: :meth:`RecommendationDataSource.read_eval` cuts the ratings
into k folds (:func:`~..models.data.kfold_split`); each fold asks the
top ``eval_query_num`` items of every user it holds out, and the user's
held-out ratings are the actuals that :class:`PrecisionAtK`,
:class:`NDCGAtK` and :class:`PositiveCount` score.

In a process group of several processes (``parallel/multihost.py``) the
data source reads only this process's storage shard and hands training
a :class:`~..models.data.ShardedColumnarRatingsSource`; the algorithm
trains over the global mesh and returns whole tables (the persisted
model). ``read_eval`` materializes the global COO there.
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
from ..controller.metric import AverageMetric, ndcg_at_k, precision_at_k
from ..controller.params import EngineParams
from ..data.bimap import BiMap
from ..models.als import (
    ALSModel,
    ALSParams,
    RatingsCOO,
    pin_user_rows,
    pin_user_rows_lanes,
    place_model,
    quantize_serving_model,
    recommend_batch,
    recommend_batch_async,
    recommend_pinned,
    recommend_products,
    replicate_model,
    shard_model,
)
from ..models.data import kfold_split, ratings_from_columnar
from ._common import train_als_on


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
        r = self.ratings
        nnz = (int(np.sum(r.row_counts("user")))
               if hasattr(r, "row_counts") else r.users.size)
        if nnz == 0:
            raise ValueError("TrainingData has no ratings; check that "
                             "rate/buy events exist for the app")


@dataclass(frozen=True)
class DataSourceParams:
    """Where the training events live and how they become ratings, and
    how :meth:`RecommendationDataSource.read_eval` folds them."""
    app_name: str = ""
    channel_name: Optional[str] = None
    eval_k: int = 0              # folds for read_eval (0 = no eval data)
    eval_query_num: int = 10     # N per eval query
    eval_rating_threshold: float = 2.0  # "relevant" cutoff for actuals
    seed: int = 3
    #: event name -> fixed rating (None: read the ``rating`` property);
    #: None means ``{"rate": None, "buy": 4.0}``
    event_weights: Optional[Dict[str, Optional[float]]] = None


@dataclass(frozen=True)
class EvalInfo:
    fold: int
    rating_threshold: float


@dataclass(frozen=True)
class ActualResult:
    """Ground truth for one eval query: the user's held-out rated items."""
    ratings: Tuple[Tuple[str, float], ...]  # (item, rating)


class RecommendationDataSource(DataSource):
    """Reads an app's rating events from the event store as columns."""

    def __init__(self, params: DataSourceParams = DataSourceParams()):
        self.params = params

    def _read_ratings(self, ctx: Context):
        from ..parallel.multihost import process_count

        weights = self.params.event_weights
        multihost = process_count() > 1
        batch = ctx.event_store.find_columnar(
            self.params.app_name or ctx.app_name,
            channel_name=self.params.channel_name,
            entity_type="user", target_entity_type="item",
            event_names=(list(weights) if weights is not None
                         else ["rate", "buy"]),
            # a bulk COO build needs neither time order nor raw JSON
            ordered=False, with_props=False,
            # several processes: this process's storage shard only (a
            # remote backend ships 1/N of the bytes); the sharded source
            # gathers each factor row's triples over the host group
            host_sharded=multihost)
        if multihost:
            from ..models.data import ShardedColumnarRatingsSource

            src = ShardedColumnarRatingsSource(batch, event_weights=weights)
            return src, src.user_ids, src.item_ids
        return ratings_from_columnar(batch, event_weights=weights)

    def read_training(self, ctx: Context) -> TrainingData:
        ratings, user_ids, item_ids = self._read_ratings(ctx)
        return TrainingData(ratings, user_ids, item_ids)

    def read_eval(self, ctx: Context):
        """K-fold split over rating entries: each fold trains on the
        other k-1 folds' entries; its queries ask the top
        ``eval_query_num`` items of each user it holds out (in user row
        order), and the actuals are that user's held-out ratings (in
        entry order)."""
        p = self.params
        if p.eval_k <= 1:
            raise ValueError("eval_k must be >= 2 for read_eval")
        ratings, user_ids, item_ids = self._read_ratings(ctx)
        if hasattr(ratings, "to_coo"):
            # folds slice entry arrays: the global COO (a collective)
            ratings = ratings.to_coo()
        # dense inverse-lookup arrays and a numpy lexsort grouping: a
        # large fold holds millions of test entries, which per-entry
        # dict lookups in a Python loop would take minutes over
        inv_u_arr = np.empty(ratings.n_users, dtype=object)
        for key, j in user_ids.items():
            inv_u_arr[j] = key
        inv_i_arr = np.empty(ratings.n_items, dtype=object)
        for key, j in item_ids.items():
            inv_i_arr[j] = key
        folds = []
        for f, (train_mask, test_mask) in enumerate(
                kfold_split(len(ratings.users), p.eval_k, p.seed)):
            td = TrainingData(
                RatingsCOO(ratings.users[train_mask],
                           ratings.items[train_mask],
                           ratings.ratings[train_mask],
                           ratings.n_users, ratings.n_items),
                user_ids, item_ids)
            te_u = ratings.users[test_mask]
            order = np.lexsort((np.arange(len(te_u)), te_u))
            u_s = te_u[order]
            i_names = inv_i_arr[ratings.items[test_mask][order]]
            r_s = ratings.ratings[test_mask][order].astype(float)
            starts = np.flatnonzero(
                np.r_[True, u_s[1:] != u_s[:-1]]) if len(u_s) else \
                np.empty(0, np.int64)
            bounds = np.r_[starts, len(u_s)]
            qa = []
            for b in range(len(starts)):
                lo, hi = bounds[b], bounds[b + 1]
                qa.append((
                    Query(user=inv_u_arr[u_s[lo]], num=p.eval_query_num),
                    ActualResult(tuple(zip(i_names[lo:hi].tolist(),
                                           r_s[lo:hi].tolist())))))
            folds.append((td, EvalInfo(
                fold=f, rating_threshold=p.eval_rating_threshold), qa))
        return folds


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


def _k_ladder(n_items: int) -> List[int]:
    """The serving ladder's k: each power of two from 8 up to
    min(128, n_items), or min(8, n_items) alone for a smaller catalog."""
    ks, k = [], 8
    while k <= min(128, n_items):
        ks.append(k)
        k *= 2
    return ks or [min(8, n_items)]


class ALSAlgorithm(Algorithm):
    """Serves a trained explicit- or implicit-feedback ALS model."""

    query_class = Query
    #: the kernel libraries serving launches on the card: a deploy loads
    #: them at bind (``csrc/fused_topk.cu``)
    serving_kernels = ("fused_topk",)

    def __init__(self, params: ALSParams = ALSParams()):
        self.params = params

    def train(self, ctx: Context, td: TrainingData) -> ALSModel:
        """Pack once per ratings object and train on ``ctx.device``, or
        over ``ctx.mesh`` (in a process group of several processes, the
        global mesh): a mesh's factors are gathered to whole tables. On
        the card, returns only once the queued iterations have run, so
        the engine's stage clock covers them."""
        U, V = train_als_on(ctx, td.ratings, self.params)
        if U.is_cuda:
            torch.cuda.synchronize(U.device)
        return ALSModel(user_factors=U, item_factors=V,
                        n_users=td.ratings.n_users,
                        n_items=td.ratings.n_items,
                        user_ids=td.user_ids, item_ids=td.item_ids,
                        params=self.params)

    def predict(self, model: ALSModel, query: Query) -> PredictedResult:
        return self._predict_impl(model, query, pinned=None)

    def _predict_impl(self, model: ALSModel, query: Query,
                      pinned) -> PredictedResult:
        """One query, ranked from the full user table, or with ``pinned``
        (a ``(table, slot)`` handle of :meth:`pin_hot_entities`) from the
        pinned table's row."""
        uidx = model.user_ids.get(query.user) if model.user_ids else None
        if uidx is None:
            return PredictedResult()  # unknown user: empty result
        # over-fetch by the blacklist size, then filter
        num = query.num + len(_black_ids(model, query))
        if pinned is not None:
            table, slot = pinned
            ids, scores = recommend_pinned(model, table, slot, num)
        else:
            ids, scores = recommend_products(model, int(uidx), num)
        return _pick(model, query, ids, scores)

    # -- the hot-entity tier's hooks -----------------------------------------
    def pin_hot_entities(self, model: ALSModel,
                         entity_keys: Sequence[str], devices=None):
        """Pin the hottest users' factor rows as ONE table on the model's
        device (:func:`~..models.als.pin_user_rows`, padded to a
        power-of-two capacity); returns ``({user: (table, slot)},
        nbytes)``. The pinned table's k-ladder (8 ... min(128, n_items))
        runs here, on the refresh thread, so the first pinned serve after
        a refresh meets a warm path. With ``devices`` (replicated lanes)
        the table goes to every lane device
        (:func:`~..models.als.pin_user_rows_lanes`) and the handle carries
        the per-device tuple, so a hot serve stays on its lane's device;
        a sharded model pins one table gathered across its shards."""
        known = [(e, int(model.user_ids[e])) for e in entity_keys
                 if model.user_ids and e in model.user_ids]
        if not known:
            return {}, 0
        cap = 1
        while cap < len(known):
            cap *= 2
        if devices and model.mesh is None:
            table, nbytes = pin_user_rows_lanes(
                model, [u for _, u in known], cap, devices)
        else:
            table, nbytes = pin_user_rows(model, [u for _, u in known],
                                          cap)
        if table is None:
            return {}, 0
        for k in _k_ladder(model.n_items):
            recommend_pinned(model, table, 0, k)
        return {e: (table, slot)
                for slot, (e, _) in enumerate(known)}, nbytes

    def predict_pinned(self, model: ALSModel, query: Query,
                       handle) -> PredictedResult:
        """Serve one query off a pinned hot-user row (the hot tier's
        path)."""
        return self._predict_impl(model, query, pinned=handle)

    def prepare_serving_model(self, model: ALSModel,
                              device: torch.device) -> ALSModel:
        """Place both factor tables on ``device`` once, at bind."""
        return place_model(model, device)

    def quantize_serving_model(self, model: ALSModel,
                               quant: str) -> ALSModel:
        """Row-quantize the serving tables behind the NDCG@10 parity
        probe (auto-off keeps f32 where the ranking would suffer)."""
        return quantize_serving_model(model, quant)

    # -- mesh-wide serving placement -----------------------------------------
    def replicate_serving_model(self, model: ALSModel,
                                device) -> ALSModel:
        """One full factor-table copy on ``device``: a replicated lane's
        model (:func:`~..models.als.replicate_model`)."""
        return replicate_model(model, device)

    def shard_serving_model(self, model: ALSModel, mesh) -> ALSModel:
        """Both factor tables split by rows over the serving mesh
        (:func:`~..models.als.shard_model`): a table bigger than one
        card's memory; serving launches ``fused_topk`` once per shard."""
        return shard_model(model, mesh)

    def warm_serving(self, model: ALSModel, max_batch: int = 1) -> int:
        """Run the serving ladder once before traffic, on the model's own
        device: :func:`recommend_products` at each power-of-two k from 8
        up to min(128, n_items), then :func:`recommend_batch` at each
        power-of-two batch up to the power-of-two ceiling of
        ``max_batch``, for each such k (the JAX package's ladder). On the
        card every call launches ``fused_topk`` (k never passes its
        limit of 128). Returns the number of calls."""
        if model.user_ids is None or len(model.user_ids) == 0:
            return 0
        ks = _k_ladder(model.n_items)
        for k in ks:
            recommend_products(model, 0, k)
        calls = len(ks)
        b = 1
        top = max(max_batch, 1)
        while True:
            for k in ks:
                recommend_batch(model, np.zeros(b, dtype=np.int64), k)
            calls += len(ks)
            if b >= top:  # b is the pow2 ceiling of max_batch
                break
            b *= 2
        return calls

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


@dataclass(frozen=True)
class FileBlacklistServingParams:
    """The file of items to drop from every answer."""
    filepath: str = ""


class FileBlacklistServing(RecommendationServing):
    """Drop the items listed (one per line) in a file re-read for every
    request."""

    def __init__(self, params: FileBlacklistServingParams
                 = FileBlacklistServingParams()):
        self.params = params

    def serve(self, query: Query, predictions) -> PredictedResult:
        disabled = set()
        if self.params.filepath:
            with open(self.params.filepath, "r", encoding="utf-8") as f:
                disabled = {line.strip() for line in f if line.strip()}
        first = predictions[0]
        return PredictedResult(tuple(
            s for s in first.item_scores if s.item not in disabled))


@dataclass(frozen=True)
class ExcludeItemsPreparatorParams:
    """Items dropped before training: read from a file (one per line)
    and given inline."""
    filepath: str = ""
    items: Tuple[str, ...] = ()


class ExcludeItemsPreparator(IdentityPreparator):
    """Drops the excluded items' ratings and re-indexes the remaining
    items densely (``BiMap.string_int`` over the kept ids in their old
    order), so an excluded item has no factor row and is never
    recommended."""

    def __init__(self, params: ExcludeItemsPreparatorParams
                 = ExcludeItemsPreparatorParams()):
        self.params = params

    def prepare(self, ctx: Context, td: TrainingData) -> TrainingData:
        excluded = set(self.params.items)
        if self.params.filepath:
            with open(self.params.filepath, "r", encoding="utf-8") as f:
                excluded |= {line.strip() for line in f if line.strip()}
        bad_idx = {td.item_ids[i] for i in excluded if i in td.item_ids}
        if not bad_idx:
            return td
        new_item_ids = BiMap.string_int(
            k for k in td.item_ids.keys() if k not in excluded)
        remap = np.full(td.ratings.n_items, -1, dtype=np.int64)
        for old_key, new_i in new_item_ids.items():
            remap[td.item_ids[old_key]] = new_i
        keep = ~np.isin(td.ratings.items, list(bad_idx))
        return TrainingData(
            RatingsCOO(td.ratings.users[keep],
                       remap[td.ratings.items[keep]].astype(
                           td.ratings.items.dtype),
                       td.ratings.ratings[keep], td.ratings.n_users,
                       len(new_item_ids)),
            td.user_ids, new_item_ids)


def recommendation_engine(datasource_classes: Optional[ClassMap] = None
                          ) -> Engine:
    """Engine factory of the template. The data source is
    :class:`RecommendationDataSource` over the event store, unless
    ``datasource_classes`` names the caller's own (yielding
    :class:`TrainingData`; its params then pass through as a dict). The
    preparator slot ``exclude`` and the serving slot ``fileblacklist``
    are the customize-data-prep and customize-serving variants."""
    own = datasource_classes is not None
    return Engine(
        algorithm_classes={"als": ALSAlgorithm, "": ALSAlgorithm},
        serving_classes={"": RecommendationServing,
                         "fileblacklist": FileBlacklistServing},
        algorithm_params_classes={"als": ALSParams, "": ALSParams},
        serving_params_class={
            "fileblacklist": FileBlacklistServingParams},
        datasource_classes=(datasource_classes if own
                            else RecommendationDataSource),
        datasource_params_class=None if own else DataSourceParams,
        preparator_classes={"": IdentityPreparator,
                            "exclude": ExcludeItemsPreparator},
        preparator_params_class={"exclude": ExcludeItemsPreparatorParams},
    )


# -- evaluation metrics ---------------------------------------------------------

class PrecisionAtK(AverageMetric):
    """Precision@K with a relevance threshold."""

    def __init__(self, k: int = 10, rating_threshold: float = 2.0):
        self.k = k
        self.rating_threshold = rating_threshold

    @property
    def header(self) -> str:
        return f"Precision@{self.k} (threshold={self.rating_threshold})"

    def calculate_point(self, ei, q: Query, p: PredictedResult,
                        a: ActualResult):
        relevant = {item for item, r in a.ratings
                    if r >= self.rating_threshold}
        return precision_at_k([s.item for s in p.item_scores], relevant,
                              self.k)


class NDCGAtK(AverageMetric):
    """Binary NDCG@K with a relevance threshold."""

    def __init__(self, k: int = 10, rating_threshold: float = 2.0):
        self.k = k
        self.rating_threshold = rating_threshold

    @property
    def header(self) -> str:
        return f"NDCG@{self.k} (threshold={self.rating_threshold})"

    def calculate_point(self, ei, q: Query, p: PredictedResult,
                        a: ActualResult):
        relevant = {item for item, r in a.ratings
                    if r >= self.rating_threshold}
        return ndcg_at_k([s.item for s in p.item_scores], relevant, self.k)


class PositiveCount(AverageMetric):
    """Average number of relevant actuals per query: a sanity
    diagnostic, not a target."""

    def __init__(self, rating_threshold: float = 2.0):
        self.rating_threshold = rating_threshold

    @property
    def header(self) -> str:
        return f"PositiveCount (threshold={self.rating_threshold})"

    def calculate_point(self, ei, q, p, a: ActualResult):
        return float(sum(1 for _, r in a.ratings
                         if r >= self.rating_threshold))


def default_engine_params(app_name: str, **als_kw) -> EngineParams:
    return EngineParams(
        datasource=("", DataSourceParams(app_name=app_name)),
        preparator=("", None),
        algorithms=(("als", ALSParams(**als_kw)),),
        serving=("", None))
