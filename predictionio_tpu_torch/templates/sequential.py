"""Sequential-recommendation template: next-item prediction from
chronological item histories through causal self-attention (the port of
``predictionio_tpu/templates/sequential.py``).

Query: ``{"user": "u1", "num": 10}`` (the recent history read from the
event store at serving time, with a 200 ms deadline) or ``{"items":
["i3", "i9"], "num": 10}`` for an explicit session history. Known items
in the history are excluded from the results.

Training runs ``models/seqrec.py::train_seqrec`` on the context's device
(the card unless it names the CPU); serving scores a batch of histories
with one ``recommend_next_batch`` on the bound model's device. The
``SeqRecModel`` kind is registered with the model file.
:meth:`SeqRecAlgorithm.warm_serving` runs the batch ladder once at bind,
as the JAX package's does, so the first query finds the card's
allocator and the host's code paths warm.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..controller import (
    Algorithm,
    Context,
    DataSource,
    Engine,
    FirstServing,
    IdentityPreparator,
    SanityCheck,
)
from ..controller.metric import AverageMetric, ndcg_at_k
from ..data.bimap import BiMap
from ..models.data import ratings_from_columnar
from ..models.seqrec import (
    SeqRecModel,
    SeqRecParams,
    place,
    recommend_next_batch,
    sequences_from_ratings,
    train_seqrec,
)
from ..workflow.persistence import bimap_json, ids_json, register_kind

log = logging.getLogger(__name__)

#: serving-time history read deadline
HISTORY_TIMEOUT_MS = 200


@dataclass(frozen=True)
class Query:
    user: Optional[str] = None
    items: Optional[Tuple[str, ...]] = None
    num: int = 10
    #: exclude history items from results (serving default). Eval turns
    #: it off: leave-one-out targets may legitimately REPEAT an item
    #: from the prefix.
    exclude_known: bool = True

    def __post_init__(self):
        if self.items is not None:
            object.__setattr__(self, "items", tuple(self.items))


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
    sequences: np.ndarray      # [n_users, max_len] int32, -1 padded
    item_ids: BiMap
    n_items: int
    events: Tuple[str, ...] = ()
    app_name: str = ""

    def sanity_check(self):
        if (self.sequences >= 0).sum() == 0:
            raise ValueError("no interaction events found")


@dataclass(frozen=True)
class DataSourceParams:
    app_name: str = ""
    #: events forming the sequence, in preference order
    events: Tuple[str, ...] = ("view", "rate", "buy")
    max_len: int = 50
    #: top-N requested by eval queries
    eval_query_num: int = 10


@dataclass(frozen=True)
class EvalInfo:
    n_users: int = 0


@dataclass(frozen=True)
class ActualResult:
    #: the held-out NEXT item (leave-one-out)
    item: str = ""


class SequentialDataSource(DataSource):
    """Chronological per-user item sequences from the columnar bulk
    read (no per-event Python objects on the training path)."""

    def __init__(self, params: DataSourceParams = DataSourceParams()):
        self.params = params

    def read_training(self, ctx: Context) -> TrainingData:
        app = self.params.app_name or ctx.app_name
        batch = ctx.event_store.find_columnar(
            app, entity_type="user", target_entity_type="item",
            event_names=list(self.params.events), ordered=False,
            with_props=False)
        coo, user_ids, item_ids = ratings_from_columnar(
            batch, event_weights={e: 1.0 for e in self.params.events})
        sel_times = self._times_for(batch, coo)
        seqs = sequences_from_ratings(coo.users, coo.items, sel_times,
                                      coo.n_users, self.params.max_len)
        return TrainingData(sequences=seqs, item_ids=item_ids,
                            n_items=coo.n_items,
                            events=tuple(self.params.events),
                            app_name=app)

    def read_eval(self, ctx: Context):
        """Leave-one-out: per user with >= 3 interactions, hold out the
        LAST item; the query carries the prefix explicitly, the actual
        is the held-out next item."""
        td = self.read_training(ctx)
        inv = td.item_ids.inverse
        train = td.sequences.copy()
        qa = []
        for row in range(len(train)):
            real = train[row][train[row] >= 0]
            if len(real) < 3:
                continue
            target = int(real[-1])
            prefix = [int(x) for x in real[:-1]]
            # drop the held-out item from the training window
            train[row, :] = -1
            train[row, -len(prefix):] = prefix
            qa.append((Query(items=tuple(inv[i] for i in prefix),
                             num=self.params.eval_query_num,
                             exclude_known=False),
                       ActualResult(item=inv[target])))
        td_train = TrainingData(sequences=train, item_ids=td.item_ids,
                                n_items=td.n_items, events=td.events,
                                app_name=td.app_name)
        return [(td_train, EvalInfo(n_users=len(qa)), qa)]

    @staticmethod
    def _times_for(batch, coo) -> np.ndarray:
        """Event times aligned to the COO entries: the batch holds only
        the requested event names (filter pushdown) with fixed weights,
        so ratings_from_columnar's selection is exactly target >= 0."""
        times = np.asarray(batch.event_time)[
            np.asarray(batch.target_id) >= 0]
        assert len(times) == len(coo.users), (len(times), len(coo.users))
        return times


class HitRateAtK(AverageMetric):
    """Fraction of users whose held-out next item appears in the top-k."""

    def __init__(self, k: int = 10):
        self.k = k

    @property
    def header(self) -> str:
        return f"HitRate@{self.k}"

    def calculate_point(self, ei, q: Query, p: PredictedResult,
                        a: ActualResult):
        top = [s.item for s in p.item_scores[: self.k]]
        return 1.0 if a.item in top else 0.0


class SeqNDCGAtK(AverageMetric):
    """Binary NDCG@k of the single held-out next item."""

    def __init__(self, k: int = 10):
        self.k = k

    @property
    def header(self) -> str:
        return f"SeqNDCG@{self.k}"

    def calculate_point(self, ei, q: Query, p: PredictedResult,
                        a: ActualResult):
        return ndcg_at_k([s.item for s in p.item_scores], {a.item},
                         self.k) or 0.0


class SeqRecAlgorithm(Algorithm):
    """DASE wrapper over :func:`train_seqrec`."""

    query_class = Query

    def __init__(self, params: SeqRecParams = SeqRecParams()):
        self.params = params

    def train(self, ctx: Context, td: TrainingData) -> SeqRecModel:
        model, _ = train_seqrec(td.sequences, td.n_items, self.params,
                                mesh=ctx.mesh, item_ids=td.item_ids,
                                events=td.events, app_name=td.app_name,
                                device=ctx.device)
        return model

    def bind_serving(self, ctx: Context) -> None:
        """User histories are read from the serving context's store."""
        self._serving_store = ctx.event_store
        self._app_name = ctx.app_name

    def prepare_serving_model(self, model: SeqRecModel,
                              device: torch.device) -> SeqRecModel:
        """Place the weights on ``device`` once, at bind."""
        return place(model, device)

    def _history_for(self, model: SeqRecModel, query: Query) -> list:
        """One query's item-index history: the explicit session items,
        or a serving-time event-store read for a user query (a failed or
        late read gives an empty history)."""
        ids: BiMap = model.item_ids
        history: list = []
        if query.items:
            history = [ids[i] for i in query.items if i in ids]
        elif query.user:
            store = getattr(self, "_serving_store", None)
            if store is None:
                from ..data.store import event_store as store  # noqa: F811
            try:
                evs = store.find_by_entity(
                    model.app_name
                    or getattr(self, "_app_name", "") or "", "user",
                    query.user, target_entity_type="item",
                    event_names=(list(model.events)
                                 if model.events else None),
                    limit=model.params.max_len, latest=True,
                    timeout_ms=HISTORY_TIMEOUT_MS)
            except Exception as err:  # serving never hard-fails
                log.error("error reading the history of %s: %s",
                          query.user, err)
                evs = []
            # latest-first -> chronological
            history = [ids[e.target_entity_id] for e in reversed(evs)
                       if e.target_entity_id in ids]
        return history

    def warm_serving(self, model: SeqRecModel, max_batch: int = 1) -> int:
        """Run :func:`recommend_next_batch` at each power-of-two batch up
        to the power-of-two ceiling of ``max_batch``, on the weights'
        device, before traffic (the JAX package's ladder; plain torch:
        seqrec has no kernel of its own). Returns the number of calls."""
        if model.n_items <= 0:
            return 0
        calls = 0
        b = 1
        top = max(max_batch, 1)
        while True:
            recommend_next_batch(model, [[0]] * b, k=10)
            calls += 1
            if b >= top:  # pow2 ceiling: the padded largest batch too
                break
            b *= 2
        return calls

    def _results(self, model: SeqRecModel, query: Query, history,
                 idx, scores) -> PredictedResult:
        known = set(history) if query.exclude_known else set()
        inv = model.item_ids.inverse
        out = [(int(i), float(s)) for i, s in zip(idx, scores)
               if int(i) not in known][: query.num]
        return PredictedResult(tuple(
            ItemScore(item=inv[i], score=s) for i, s in out))

    def predict(self, model: SeqRecModel, query: Query) -> PredictedResult:
        # single-query = batch of one: exactly one over-fetch rule
        return self.batch_predict(model, [query])[0]

    def batch_predict(self, model: SeqRecModel,
                      queries: Sequence[Query]) -> List[PredictedResult]:
        """One ``recommend_next_batch`` for the whole batch; the store
        reads of user queries run concurrently, on up to 8 threads."""
        if len(queries) > 1:
            with ThreadPoolExecutor(
                    max_workers=min(8, len(queries))) as pool:
                hists = list(pool.map(
                    lambda q: self._history_for(model, q), queries))
        else:
            hists = [self._history_for(model, q) for q in queries]
        live = [i for i, h in enumerate(hists) if h]
        out: List[PredictedResult] = [PredictedResult()] * len(queries)
        if not live:
            return out
        k = max(queries[i].num
                + (len(set(hists[i]))
                   if queries[i].exclude_known else 0)
                for i in live)
        ids, scores = recommend_next_batch(
            model, [hists[i] for i in live],
            k=min(k, model.n_items))
        for row, i in enumerate(live):
            out[i] = self._results(model, queries[i], hists[i],
                                   ids[row], scores[row])
        return out


class SequentialServing(FirstServing):
    pass


def sequential_engine() -> Engine:
    """Engine factory."""
    return Engine(
        datasource_classes=SequentialDataSource,
        preparator_classes=IdentityPreparator,
        algorithm_classes={"seqrec": SeqRecAlgorithm,
                           "": SeqRecAlgorithm},
        serving_classes=SequentialServing,
        datasource_params_class=DataSourceParams,
        algorithm_params_classes={"seqrec": SeqRecParams,
                                  "": SeqRecParams},
    )


# -- the model file -------------------------------------------------------------

def _encode_seqrec(m: SeqRecModel) -> Tuple[Dict[str, np.ndarray], dict]:
    return ({f"w.{k}": v.detach().cpu().numpy()
             for k, v in m.weights.items()},
            {"n_items": m.n_items, "item_ids": ids_json(m.item_ids),
             "params": asdict(m.params),
             "events": None if m.events is None else list(m.events),
             "app_name": m.app_name})


def _decode_seqrec(arrays: Dict[str, np.ndarray], m: dict) -> SeqRecModel:
    return SeqRecModel(
        weights={k[2:]: torch.from_numpy(v) for k, v in arrays.items()
                 if k.startswith("w.")},
        n_items=m["n_items"], item_ids=bimap_json(m["item_ids"]),
        params=SeqRecParams(**m["params"]),
        events=None if m["events"] is None else tuple(m["events"]),
        app_name=m["app_name"])


register_kind("SeqRecModel", SeqRecModel, _encode_seqrec, _decode_seqrec,
              module=__name__)
