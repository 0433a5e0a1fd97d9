"""DASE controller API: what engine templates and evaluations import
(the port's counterpart of ``predictionio_tpu.controller``'s exports,
custom persistence included: :mod:`.persistent`).
"""

from .base import (
    Algorithm,
    AverageServing,
    DataSource,
    FirstServing,
    IdentityPreparator,
    PersistentModelManifest,
    Preparator,
    SanityCheck,
    Serving,
)
from .cleaning import EventWindow, SelfCleaningDataSource
from .context import Context, default_context
from .engine import Engine, EngineFactory, SimpleEngine, TrainResult
from .evaluation import (
    EngineParamsGenerator,
    Evaluation,
    MetricEvaluator,
    MetricEvaluatorResult,
    save_best_variant_json,
)
from .fast_eval import FastEvalEngine, FastEvalEngineWorkflow
from .persistent import LocalFileSystemPersistentModel, PersistentModel
from .metric import (
    AverageMetric,
    Metric,
    OptionAverageMetric,
    OptionStdevMetric,
    PointwiseMetric,
    StdevMetric,
    SumMetric,
    ZeroMetric,
    ndcg_at_k,
    precision_at_k,
)
from .params import (
    EmptyParams,
    EngineParams,
    Params,
    engine_params_from_variant,
    load_variant,
    params_from_json,
    params_to_json,
)

__all__ = [
    "PersistentModel",
    "LocalFileSystemPersistentModel",
    "FastEvalEngineWorkflow",
    "FastEvalEngine",
    "Algorithm",
    "AverageMetric",
    "AverageServing",
    "Context",
    "DataSource",
    "EmptyParams",
    "Engine",
    "EngineFactory",
    "EngineParams",
    "EngineParamsGenerator",
    "Evaluation",
    "EventWindow",
    "FirstServing",
    "IdentityPreparator",
    "Metric",
    "MetricEvaluator",
    "MetricEvaluatorResult",
    "OptionAverageMetric",
    "OptionStdevMetric",
    "Params",
    "PersistentModelManifest",
    "PointwiseMetric",
    "Preparator",
    "SanityCheck",
    "SelfCleaningDataSource",
    "Serving",
    "SimpleEngine",
    "StdevMetric",
    "SumMetric",
    "TrainResult",
    "ZeroMetric",
    "default_context",
    "engine_params_from_variant",
    "load_variant",
    "ndcg_at_k",
    "params_from_json",
    "params_to_json",
    "precision_at_k",
    "save_best_variant_json",
]
