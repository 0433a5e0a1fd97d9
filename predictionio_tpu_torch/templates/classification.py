"""Classification engine template, two algorithms (the port of
``predictionio_tpu/templates/classification.py``).

Capability parity with the reference
``examples/scala-parallel-classification/add-algorithm/``: the data
source aggregates ``user`` entity properties requiring ``plan`` (the
label) and ``attr0/attr1/attr2`` (features); the algorithms are
MLlib-style multinomial naive Bayes with ``lambda`` smoothing and a
random forest; queries carry the three attributes and predictions return
the label.

Training is host numpy, as in the JAX package (``models/classify.py``).
``predict`` answers one query on the host (naive Bayes in float64);
``batch_predict`` scores the batch on the model's device, the card
unless training or the serving bind named the CPU. Both model kinds are
registered with the model file.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..controller import (
    Algorithm,
    AverageMetric,
    Context,
    DataSource,
    Engine,
    EngineParams,
    FirstServing,
    IdentityPreparator,
    SanityCheck,
)
from ..e2.cross_validation import split_data
from ..models.classify import (
    NaiveBayesModel,
    RandomForestModel,
    RandomForestParams,
    train_naive_bayes_multinomial,
    train_random_forest,
)
from ..workflow.persistence import register_kind


@dataclass(frozen=True)
class Query:
    attr0: float
    attr1: float
    attr2: float


@dataclass(frozen=True)
class PredictedResult:
    label: float

    def to_json(self) -> dict:
        return {"label": self.label}


@dataclass(frozen=True)
class ActualResult:
    label: float


@dataclass
class TrainingData(SanityCheck):
    features: np.ndarray  # [N, 3]
    labels: np.ndarray    # [N]

    def sanity_check(self):
        if len(self.features) == 0:
            raise ValueError("TrainingData is empty; are user entities "
                             "missing plan/attr0/attr1/attr2 properties?")


@dataclass(frozen=True)
class DataSourceParams:
    app_name: str = ""
    eval_k: Optional[int] = None


_REQUIRED = ("plan", "attr0", "attr1", "attr2")


class ClassificationDataSource(DataSource):
    def __init__(self, params: DataSourceParams = DataSourceParams()):
        self.params = params

    def _read_points(self, ctx: Context) -> Tuple[np.ndarray, np.ndarray]:
        props = ctx.event_store.aggregate_properties(
            self.params.app_name or ctx.app_name, entity_type="user",
            required=list(_REQUIRED))
        feats, labels = [], []
        for entity_id, pm in sorted(props.items()):
            labels.append(float(pm.get("plan")))
            feats.append([float(pm.get("attr0")), float(pm.get("attr1")),
                          float(pm.get("attr2"))])
        return (np.asarray(feats, dtype=np.float64).reshape(-1, 3),
                np.asarray(labels, dtype=np.float64))

    def read_training(self, ctx: Context) -> TrainingData:
        X, y = self._read_points(ctx)
        return TrainingData(X, y)

    def read_eval(self, ctx: Context):
        """k-fold split, fold i tests points with index % k == i."""
        if not self.params.eval_k:
            raise ValueError("DataSourceParams.eval_k must be set for eval")
        X, y = self._read_points(ctx)
        points = list(zip(X, y))
        return split_data(
            self.params.eval_k, points, evaluator_info=None,
            training_data_creator=lambda pts: TrainingData(
                np.asarray([p[0] for p in pts]).reshape(-1, 3),
                np.asarray([p[1] for p in pts])),
            query_creator=lambda p: Query(*map(float, p[0])),
            actual_creator=lambda p: ActualResult(float(p[1])))


@dataclass(frozen=True)
class NaiveBayesParams:
    lambda_: float = 1.0


def _device_name(device) -> Optional[str]:
    return None if device is None else str(device)


def _features(queries: Sequence[Query]) -> np.ndarray:
    return np.asarray([[q.attr0, q.attr1, q.attr2] for q in queries],
                      dtype=np.float64).reshape(-1, 3)


class NaiveBayesAlgorithm(Algorithm):
    query_class = Query

    def __init__(self, params: NaiveBayesParams = NaiveBayesParams()):
        self.params = params

    def train(self, ctx: Context, data: TrainingData) -> NaiveBayesModel:
        if len(data.features) == 0:
            raise ValueError("labeledPoints cannot be empty")
        model = train_naive_bayes_multinomial(data.features, data.labels,
                                              lam=self.params.lambda_)
        model.device = _device_name(ctx.device)
        return model

    def prepare_serving_model(self, model: NaiveBayesModel,
                              device: torch.device) -> NaiveBayesModel:
        """Score batches on the serving device."""
        return dataclasses.replace(model, device=str(device))

    def predict(self, model: NaiveBayesModel, query: Query
                ) -> PredictedResult:
        return PredictedResult(model.predict(
            [query.attr0, query.attr1, query.attr2]))

    def batch_predict(self, model: NaiveBayesModel,
                      queries: Sequence[Query]) -> List[PredictedResult]:
        return [PredictedResult(float(l))
                for l in model.predict_batch(_features(queries))]


class RandomForestAlgorithm(Algorithm):
    query_class = Query

    def __init__(self, params: RandomForestParams = RandomForestParams()):
        self.params = params

    def train(self, ctx: Context, data: TrainingData) -> RandomForestModel:
        if len(data.features) == 0:
            raise ValueError("labeledPoints cannot be empty")
        model = train_random_forest(data.features, data.labels, self.params)
        model.device = _device_name(ctx.device)
        return model

    def prepare_serving_model(self, model: RandomForestModel,
                              device: torch.device) -> RandomForestModel:
        """Traverse on the serving device."""
        return _forest(_forest_arrays(model), model.classes,
                       model.max_depth, str(device))

    def predict(self, model: RandomForestModel, query: Query
                ) -> PredictedResult:
        return PredictedResult(model.predict(
            [query.attr0, query.attr1, query.attr2]))

    def batch_predict(self, model: RandomForestModel,
                      queries: Sequence[Query]) -> List[PredictedResult]:
        return [PredictedResult(float(l))
                for l in model.predict_batch(_features(queries))]


class Accuracy(AverageMetric):
    """Fraction of exact label matches (the template's eval metric)."""

    header = "Accuracy"

    def calculate_point(self, ei, q: Query, p: PredictedResult,
                        a: ActualResult) -> float:
        return 1.0 if p.label == a.label else 0.0


def classification_engine() -> Engine:
    """``Engine.scala`` factory: naive Bayes + random forest slots."""
    return Engine(
        datasource_classes=ClassificationDataSource,
        preparator_classes=IdentityPreparator,
        algorithm_classes={"naive": NaiveBayesAlgorithm,
                           "randomforest": RandomForestAlgorithm,
                           "": NaiveBayesAlgorithm},
        serving_classes=FirstServing,
        datasource_params_class=DataSourceParams,
        algorithm_params_classes={"naive": NaiveBayesParams,
                                  "randomforest": RandomForestParams,
                                  "": NaiveBayesParams},
    )


def default_engine_params(app_name: str, algo: str = "naive",
                          **algo_kw) -> EngineParams:
    params_cls = {"naive": NaiveBayesParams,
                  "randomforest": RandomForestParams}[algo]
    return EngineParams(
        datasource=("", DataSourceParams(app_name=app_name)),
        algorithms=[(algo, params_cls(**algo_kw))],
    )


# -- the model file -------------------------------------------------------------

_NB_ARRAYS = ("log_priors", "log_likelihoods", "classes")
_RF_ARRAYS = ("feature", "threshold", "left", "right", "leaf")


def _encode_nb(m: NaiveBayesModel) -> Tuple[Dict[str, np.ndarray], dict]:
    return {k: np.asarray(getattr(m, k)) for k in _NB_ARRAYS}, {}


def _decode_nb(arrays: Dict[str, np.ndarray], m: dict) -> NaiveBayesModel:
    return NaiveBayesModel(**{k: arrays[k] for k in _NB_ARRAYS})


def _forest_arrays(m: RandomForestModel) -> Dict[str, np.ndarray]:
    return {k: np.asarray(getattr(m, k)) for k in _RF_ARRAYS}


def _forest(arrays: Dict[str, np.ndarray], classes: np.ndarray,
            max_depth: int, device: Optional[str] = None
            ) -> RandomForestModel:
    return RandomForestModel(*(arrays[k] for k in _RF_ARRAYS), classes,
                             max_depth, device)


def _encode_rf(m: RandomForestModel) -> Tuple[Dict[str, np.ndarray], dict]:
    return ({**_forest_arrays(m), "classes": np.asarray(m.classes)},
            {"max_depth": m.max_depth})


def _decode_rf(arrays: Dict[str, np.ndarray], m: dict) -> RandomForestModel:
    return _forest(arrays, arrays["classes"], m["max_depth"])


register_kind("NaiveBayesModel", NaiveBayesModel, _encode_nb, _decode_nb,
              module=__name__)
register_kind("RandomForestModel", RandomForestModel, _encode_rf, _decode_rf,
              module=__name__)
