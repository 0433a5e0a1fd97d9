"""Evaluation and hyperparameter tuning: the port of
``predictionio_tpu/controller/evaluation.py``.

An :class:`Evaluation` couples an engine with the metric to optimize and
others to report; an :class:`EngineParamsGenerator` yields the search
grid; :class:`MetricEvaluator` scores every params set and picks the best
by ``metric.compare``. The evaluator memoizes the pipeline's prefixes
(datasource params -> folds; + preparator params -> prepared folds; +
algorithm params -> the model of each fold) keyed by the params JSON, so
a grid that varies only the algorithm reads and prepares the folds once
and trains each (fold, algorithm params) pair once, also when the grid
is walked on several threads.
"""

from __future__ import annotations

import json
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence

from ..utils.memo import ComputeOnce
from .context import Context
from .engine import Engine
from .metric import Metric
from .params import EngineParams, params_to_json

log = logging.getLogger(__name__)


class EngineParamsGenerator:
    """Subclass and set ``engine_params_list``."""

    engine_params_list: Sequence[EngineParams] = ()


@dataclass
class Evaluation:
    """An engine and the metric(s) to optimize."""

    engine: Engine
    metric: Metric
    other_metrics: Sequence[Metric] = ()

    @property
    def metrics(self) -> List[Metric]:
        return [self.metric, *self.other_metrics]


@dataclass
class MetricScores:
    engine_params: EngineParams
    score: float
    other_scores: List[float]
    train_s: float = 0.0
    eval_s: float = 0.0


@dataclass
class MetricEvaluatorResult:
    """Outcome of a sweep; its text forms are the JAX package's, byte for
    byte."""

    best_score: float
    best_engine_params: EngineParams
    best_index: int
    metric_header: str
    other_metric_headers: List[str]
    scores: List[MetricScores] = field(default_factory=list)

    def to_one_liner(self) -> str:
        return (f"[{self.metric_header}] best variant {self.best_index}: "
                f"{self.best_score:.6f}")

    def to_json(self) -> str:
        return json.dumps({
            "bestScore": self.best_score,
            "bestIndex": self.best_index,
            "bestEngineParams": self.best_engine_params.to_json(),
            "metricHeader": self.metric_header,
            "otherMetricHeaders": self.other_metric_headers,
            "metricScoresList": [
                {"score": s.score, "otherScores": s.other_scores,
                 "engineParams": s.engine_params.to_json(),
                 "trainS": s.train_s, "evalS": s.eval_s}
                for s in self.scores],
        }, indent=2)

    def to_html(self) -> str:
        rows = "".join(
            f"<tr><td>{i}</td><td>{s.score:.6f}</td>"
            f"<td><pre>{json.dumps(s.engine_params.to_json(), indent=1)}"
            f"</pre></td></tr>"
            for i, s in enumerate(self.scores))
        return (f"<html><body><h1>{self.metric_header}</h1>"
                f"<p>{self.to_one_liner()}</p>"
                f"<table border=1><tr><th>#</th><th>score</th>"
                f"<th>params</th></tr>{rows}</table></body></html>")


def _key(pair: Any) -> str:
    """Cache key for a (name, params) slot pair."""
    name, params = pair
    return json.dumps(
        [name, params_to_json(params) if params is not None else None],
        sort_keys=True, default=str)


class MetricEvaluator:
    """Scores every engine-params set; memoizes shared pipeline prefixes.
    ``parallelism > 1`` walks the grid with a thread pool: the kernels
    queue on one card either way, but packing, result decoding and
    metric arithmetic on the host overlap across grid points. Opt-in,
    because user data sources and algorithms written for one thread must
    not run concurrently by default."""

    def __init__(self, evaluation: Evaluation,
                 parallelism: Optional[int] = None):
        self.evaluation = evaluation
        self.parallelism = parallelism if parallelism is not None else 1

    def evaluate(self, ctx: Context,
                 params_list: Sequence[EngineParams]) -> MetricEvaluatorResult:
        engine = self.evaluation.engine
        metric = self.evaluation.metric
        fold_cache = ComputeOnce()
        prep_cache = ComputeOnce()
        model_cache = ComputeOnce()

        def score_one(idx: int, ep: EngineParams) -> MetricScores:
            t0 = time.monotonic()
            ds_key = _key(ep.datasource)
            folds = fold_cache.get(
                ds_key, lambda: engine.make_datasource(ep).read_eval(ctx))
            if not folds:
                raise ValueError(
                    "DataSource.read_eval returned no folds; evaluation "
                    "requires read_eval to be implemented")

            prep_key = ds_key + "|" + _key(ep.preparator)
            prepared = prep_cache.get(prep_key, lambda: [
                engine.make_preparator(ep).prepare(ctx, td)
                for td, _, _ in folds])

            serving = engine.make_serving(ep)
            eval_data = []
            t_train = 0.0
            t_blocked = 0.0  # waiting on another thread's memoized work
            for fold_i, (pd, (td, ei, qa)) in enumerate(zip(prepared, folds)):
                queries = [serving.supplement(q) for q, _ in qa]
                actuals = [a for _, a in qa]
                per_algo = []
                for algo_pair, algo in zip(ep.algorithms,
                                           engine.make_algorithms(ep)):
                    m_key = prep_key + f"|f{fold_i}|" + _key(algo_pair)
                    w0 = time.monotonic()
                    model, spent = model_cache.get_timed(
                        m_key, lambda: algo.train(ctx, pd))
                    t_train += spent
                    t_blocked += (time.monotonic() - w0) - spent
                    per_algo.append(algo.batch_predict(model, queries))
                served = [serving.serve(q, [p[i] for p in per_algo])
                          for i, q in enumerate(queries)]
                eval_data.append((ei, list(zip(queries, served, actuals))))

            score = metric.calculate(eval_data)
            others = [m.calculate(eval_data)
                      for m in self.evaluation.other_metrics]
            log.info("params %d/%d: %s = %f", idx + 1, len(params_list),
                     metric.header, score)
            return MetricScores(
                engine_params=ep, score=score, other_scores=others,
                train_s=t_train,
                eval_s=time.monotonic() - t0 - t_blocked)

        workers = max(1, int(self.parallelism))
        if workers <= 1 or len(params_list) <= 1:
            scores = [score_one(i, ep) for i, ep in enumerate(params_list)]
        else:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                scores = list(pool.map(score_one, range(len(params_list)),
                                       params_list))

        best_index = 0
        for i in range(1, len(scores)):
            if metric.compare(scores[i].score, scores[best_index].score) > 0:
                best_index = i
        best = scores[best_index]
        return MetricEvaluatorResult(
            best_score=best.score,
            best_engine_params=best.engine_params,
            best_index=best_index,
            metric_header=metric.header,
            other_metric_headers=[m.header for m in
                                  self.evaluation.other_metrics],
            scores=scores)


def save_best_variant_json(result: MetricEvaluatorResult, path: str,
                           base_variant: Optional[dict] = None) -> None:
    """Write the winning params as an engine-variant JSON (atomically:
    a temporary file, fsync, rename)."""
    ep = result.best_engine_params.to_json()
    variant = dict(base_variant or {})
    variant.update({
        "datasource": ep["dataSourceParams"],
        "preparator": ep["preparatorParams"],
        "algorithms": ep["algorithmsParams"],
        "serving": ep["servingParams"],
    })
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(variant, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
