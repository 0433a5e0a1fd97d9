"""Streaming incremental training: the event -> model loop (the port of
``predictionio_tpu/streaming/``).

A :class:`StreamTrainer` thread tails the event log behind a durable
:class:`EventCursor` (persisted through EVENTDATA, bus-woken), folds
micro-batches of fresh events into the deployed ALS model through
per-entity least-squares solves against the fixed opposite factors
(:func:`~predictionio_tpu_torch.models.als.fold_in_rows`: the same
``fused_gram`` and ``chol_solve`` kernels the batch trainer launches),
canaries every delta with a
:class:`~predictionio_tpu_torch.rollout.policy.HealthPolicy` probe, and
hot-swaps the folded model into the live serving binding. A
:class:`DriftMonitor` flags when a full retrain is due.
"""

from .cursor import CURSOR_ENTITY_TYPE, EventCursor
from .drift import DriftMonitor
from .foldin import (
    DEFAULT_EVENT_WEIGHTS,
    FoldInReport,
    fold_in_events,
    project_ratings,
)
from .trainer import StreamConfig, StreamTrainer

__all__ = [
    "CURSOR_ENTITY_TYPE",
    "DEFAULT_EVENT_WEIGHTS",
    "DriftMonitor",
    "EventCursor",
    "FoldInReport",
    "StreamConfig",
    "StreamTrainer",
    "fold_in_events",
    "project_ratings",
]
