"""FastEvalEngine: prefix-memoized hyperparameter evaluation (the port of
``predictionio_tpu/controller/fast_eval.py``).

When a sweep varies only algorithm params, the DataSource read and the
Preparator output are computed once and shared across every variant;
when it varies only serving params, even the per-algorithm train and
batch-predict results are shared. Cache keys are the JSON rendering of
the (name, params) prefix.
"""

from __future__ import annotations

import json
import logging
from typing import Dict, List, Sequence, Tuple

from .base import Serving
from .context import Context
from .engine import Engine
from .params import EngineParams, params_to_json

log = logging.getLogger(__name__)


def _key(*pairs) -> str:
    """Stable hashable rendering of a params prefix."""
    return json.dumps([[name, params_to_json(p)] for name, p in pairs],
                      sort_keys=True, default=str)


class FastEvalEngineWorkflow:
    """Memoizing evaluator over one engine and one context."""

    def __init__(self, engine: Engine, ctx: Context):
        self.engine = engine
        self.ctx = ctx
        self.datasource_cache: Dict[str, list] = {}
        self.preparator_cache: Dict[str, list] = {}
        self.algorithms_cache: Dict[str, list] = {}
        self.serving_cache: Dict[str, list] = {}
        #: cache misses, keyed like the caches
        self.miss_counts: Dict[str, int] = {
            "datasource": 0, "preparator": 0, "algorithms": 0, "serving": 0}

    def datasource_result(self, ep: EngineParams) -> list:
        key = _key(ep.datasource)
        if key not in self.datasource_cache:
            self.miss_counts["datasource"] += 1
            ds = self.engine.make_datasource(ep)
            self.datasource_cache[key] = list(ds.read_eval(self.ctx))
        return self.datasource_cache[key]

    def preparator_result(self, ep: EngineParams) -> list:
        key = _key(ep.datasource, ep.preparator)
        if key not in self.preparator_cache:
            self.miss_counts["preparator"] += 1
            prep = self.engine.make_preparator(ep)
            folds = self.datasource_result(ep)
            self.preparator_cache[key] = [
                prep.prepare(self.ctx, td) for td, _, _ in folds]
        return self.preparator_cache[key]

    def algorithms_result(self, ep: EngineParams) -> list:
        """Per fold: (supplemented queries, per-query per-algo
        predictions). Queries are supplemented before prediction, as in
        ``Engine.eval``; when the Serving class overrides ``supplement``,
        the serving params join the cache key (predictions then depend
        on them)."""
        serving = self.engine.make_serving(ep)
        supplement_overridden = (
            type(serving).supplement is not Serving.supplement)
        pairs = [ep.datasource, ep.preparator, *ep.algorithms]
        if supplement_overridden:
            pairs.append(ep.serving)
        key = _key(*pairs)
        if key not in self.algorithms_cache:
            self.miss_counts["algorithms"] += 1
            folds = self.datasource_result(ep)
            prepared = self.preparator_result(ep)
            algos = self.engine.make_algorithms(ep)
            per_fold = []
            for (td, ei, qa), pd in zip(folds, prepared):
                queries = [serving.supplement(q) for q, _ in qa]
                per_algo = [a.batch_predict(a.train(self.ctx, pd), queries)
                            for a in algos]
                per_fold.append((queries,
                                 [[preds[i] for preds in per_algo]
                                  for i in range(len(queries))]))
            self.algorithms_cache[key] = per_fold
        return self.algorithms_cache[key]

    def serving_result(self, ep: EngineParams) -> list:
        """Final eval shape: per fold ``(eval_info, [(q, served, a)])``."""
        key = _key(ep.datasource, ep.preparator, *ep.algorithms, ep.serving)
        if key not in self.serving_cache:
            self.miss_counts["serving"] += 1
            folds = self.datasource_result(ep)
            algo_results = self.algorithms_result(ep)
            serving = self.engine.make_serving(ep)
            out = []
            for (td, ei, qa), (queries, fold_preds) in zip(folds,
                                                           algo_results):
                served = [serving.serve(q, preds)
                          for q, preds in zip(queries, fold_preds)]
                out.append((ei, [(q, s, a) for q, s, (_, a)
                                 in zip(queries, served, qa)]))
            self.serving_cache[key] = out
        return self.serving_cache[key]


class FastEvalEngine(Engine):
    """Drop-in Engine whose ``eval``/``batch_eval`` memoize pipeline
    prefixes across engine-params variants. Build from an existing
    engine: ``FastEvalEngine.from_engine(engine)``."""

    @classmethod
    def from_engine(cls, engine: Engine) -> "FastEvalEngine":
        fe = cls.__new__(cls)
        fe.__dict__.update(engine.__dict__)
        return fe

    def workflow_for(self, ctx: Context) -> FastEvalEngineWorkflow:
        """The memoization state for one context, kept ON the context so
        the fold and prediction data live exactly as long as the sweep's
        context does: the engine never pins it."""
        cache = getattr(ctx, "_fast_eval_workflows", None)
        if cache is None:
            cache = {}
            object.__setattr__(ctx, "_fast_eval_workflows", cache)
        wf = cache.get(id(self))
        if wf is None:
            wf = FastEvalEngineWorkflow(self, ctx)
            cache[id(self)] = wf
        return wf

    def eval(self, ctx: Context, engine_params: EngineParams) -> list:
        return self.workflow_for(ctx).serving_result(engine_params)

    def batch_eval(self, ctx: Context,
                   params_list: Sequence[EngineParams]
                   ) -> List[Tuple[EngineParams, list]]:
        wf = self.workflow_for(ctx)
        out = [(ep, wf.serving_result(ep)) for ep in params_list]
        log.info("FastEvalEngine misses: %s", wf.miss_counts)
        return out
