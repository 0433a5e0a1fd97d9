"""Workflow layer: the train, eval and deploy drivers, model persistence
and step checkpoints."""

from .core import (
    get_latest_completed,
    load_models_for_deploy,
    run_evaluation,
    run_train,
)
from .persistence import dumps_models, loads_models, to_device, to_host

__all__ = [
    "dumps_models",
    "get_latest_completed",
    "load_models_for_deploy",
    "loads_models",
    "run_evaluation",
    "run_train",
    "to_device",
    "to_host",
]
