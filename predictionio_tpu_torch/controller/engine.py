"""Engine: binds named DASE component classes, trains and evaluates (the
port of ``predictionio_tpu/controller/engine.py``). A persisted model's
re-materialization at deploy is :meth:`Engine.prepare_deploy`, called by
``workflow.core.load_models_for_deploy``: a model stored as ``None``
retrains the engine once, every other goes through its algorithm's
``load_persistent_model``."""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type, Union

from .base import Algorithm, DataSource, Preparator, SanityCheck, Serving
from .context import Context
from .params import EngineParams, engine_params_from_variant, instantiate

log = logging.getLogger(__name__)

ClassMap = Union[Type, Dict[str, Type]]


def _as_map(x: Optional[ClassMap]) -> Dict[str, Type]:
    if x is None:
        return {}
    return x if isinstance(x, dict) else {"": x}


def _sanity(obj: Any, what: str, skip: bool) -> None:
    if skip:
        return
    if isinstance(obj, SanityCheck):
        log.info("sanity check %s", what)
        obj.sanity_check()


@dataclass
class TrainResult:
    """Everything ``train`` produced: per-algorithm models in params
    order."""

    models: List[Any]
    engine_params: EngineParams


class Engine:
    """Named class maps for every DASE slot, and training."""

    def __init__(self, algorithm_classes: ClassMap,
                 serving_classes: ClassMap,
                 algorithm_params_classes: Optional[Dict[str, Type]] = None,
                 serving_params_class: Optional[Type] = None, *,
                 datasource_classes: Optional[ClassMap] = None,
                 preparator_classes: Optional[ClassMap] = None,
                 datasource_params_class: Optional[Type] = None,
                 preparator_params_class: Optional[Type] = None):
        self.algorithm_classes = _as_map(algorithm_classes)
        self.serving_classes = _as_map(serving_classes)
        self.algorithm_params_classes = algorithm_params_classes or {}
        self.serving_params_class = serving_params_class
        self.datasource_classes = _as_map(datasource_classes)
        self.preparator_classes = _as_map(preparator_classes)
        self.datasource_params_class = datasource_params_class
        self.preparator_params_class = preparator_params_class

    def _make(self, classes: Dict[str, Type], pair: Tuple[str, Any],
              slot: str):
        name, params = pair
        if name not in classes:
            raise KeyError(f"{slot} {name!r} not registered "
                           f"(available: {sorted(classes)})")
        return instantiate(classes[name], params)

    def make_datasource(self, ep: EngineParams) -> DataSource:
        return self._make(self.datasource_classes, ep.datasource,
                          "datasource")

    def make_preparator(self, ep: EngineParams) -> Preparator:
        return self._make(self.preparator_classes, ep.preparator,
                          "preparator")

    def make_algorithms(self, ep: EngineParams) -> List[Algorithm]:
        return [self._make(self.algorithm_classes, pair, "algorithm")
                for pair in ep.algorithms]

    def make_serving(self, ep: EngineParams) -> Serving:
        return self._make(self.serving_classes, ep.serving, "serving")

    def params_from_variant(self, variant: dict) -> EngineParams:
        return engine_params_from_variant(
            variant,
            datasource_params_cls=self.datasource_params_class,
            preparator_params_cls=self.preparator_params_class,
            algorithm_params_classes=self.algorithm_params_classes,
            serving_params_cls=self.serving_params_class)

    def train(self, ctx: Context, engine_params: EngineParams) -> TrainResult:
        """Read, sanity-check, prepare, sanity-check, then train every
        algorithm and sanity-check its model; ``ctx.stop_after_read`` and
        ``ctx.stop_after_prepare`` end early with no models. Stage
        seconds land in ``ctx.stage_timings``."""
        stages = ctx.stage_timings
        t0 = time.monotonic()
        datasource = self.make_datasource(engine_params)
        td = datasource.read_training(ctx)
        stages["read_s"] = round(time.monotonic() - t0, 2)
        _sanity(td, "training data", ctx.skip_sanity_check)
        if ctx.stop_after_read:
            log.info("stopping after read")
            return TrainResult(models=[], engine_params=engine_params)

        t0 = time.monotonic()
        preparator = self.make_preparator(engine_params)
        pd = preparator.prepare(ctx, td)
        stages["prepare_s"] = round(time.monotonic() - t0, 2)
        _sanity(pd, "prepared data", ctx.skip_sanity_check)
        if ctx.stop_after_prepare:
            log.info("stopping after prepare")
            return TrainResult(models=[], engine_params=engine_params)

        models = []
        t0 = time.monotonic()
        for i, algo in enumerate(self.make_algorithms(engine_params)):
            log.info("training algorithm %d: %s", i, type(algo).__name__)
            model = algo.train(ctx, pd)
            _sanity(model, f"model[{i}]", ctx.skip_sanity_check)
            models.append(model)
        stages["algo_train_s"] = round(time.monotonic() - t0, 2)
        return TrainResult(models=models, engine_params=engine_params)

    def eval(self, ctx: Context, engine_params: EngineParams
             ) -> List[Tuple[Any, List[Tuple[Any, Any, Any]]]]:
        """Per fold ``(eval_info, [(query, served prediction, actual)])``.
        Trains every algorithm on every fold, predicts with
        ``batch_predict`` and serves the aligned per-algorithm
        predictions."""
        datasource = self.make_datasource(engine_params)
        folds = datasource.read_eval(ctx)
        preparator = self.make_preparator(engine_params)
        serving = self.make_serving(engine_params)
        results = []
        for fold_i, (td, eval_info, qa) in enumerate(folds):
            pd = preparator.prepare(ctx, td)
            queries = [serving.supplement(q) for q, _ in qa]
            actuals = [a for _, a in qa]
            per_algo: List[List[Any]] = []
            for algo in self.make_algorithms(engine_params):
                model = algo.train(ctx, pd)
                per_algo.append(algo.batch_predict(model, queries))
            served = [serving.serve(q, [preds[i] for preds in per_algo])
                      for i, q in enumerate(queries)]
            results.append((eval_info, list(zip(queries, served, actuals))))
            log.info("eval fold %d: %d queries", fold_i, len(queries))
        return results

    def batch_eval(self, ctx: Context, params_list: Sequence[EngineParams]
                   ) -> List[Tuple[EngineParams, list]]:
        """:meth:`eval` of every params set."""
        return [(ep, self.eval(ctx, ep)) for ep in params_list]

    def prepare_deploy(self, ctx: Context, engine_params: EngineParams,
                       stored_models: List[Any],
                       engine_instance_id: str) -> List[Any]:
        """Turn persisted stand-ins back into live models: a ``None``
        (an algorithm that persists nothing, the reference's Unit model)
        retrains the engine once on the context's device; every other
        goes through its algorithm's ``load_persistent_model``."""
        algos = self.make_algorithms(engine_params)
        if len(stored_models) != len(algos):
            raise ValueError(f"{len(stored_models)} stored models for "
                             f"{len(algos)} algorithms")
        retrained: Optional[List[Any]] = None
        if any(m is None for m in stored_models):
            log.info("instance %s: ephemeral model(s) present; retraining "
                     "for deploy", engine_instance_id)
            retrained = self.train(ctx, engine_params).models
        return [retrained[i] if stored is None
                else algo.load_persistent_model(ctx, stored)
                for i, (algo, stored) in enumerate(zip(algos, stored_models))]


class SimpleEngine(Engine):
    """Single-class engine with the identity preparator and first
    serving."""

    def __init__(self, datasource_class: Type, algorithm_class: Type, **kw):
        from .base import FirstServing, IdentityPreparator
        super().__init__(algorithm_class, FirstServing,
                         datasource_classes=datasource_class,
                         preparator_classes=IdentityPreparator, **kw)


class EngineFactory:
    """Convention object templates export: subclass, or provide a
    callable returning an :class:`Engine`."""

    def apply(self) -> Engine:
        raise NotImplementedError
