"""DASE serving contracts: Algorithm and Serving (the serving half of
``predictionio_tpu/controller/base.py``).

An algorithm predicts from a model bound at deploy; a serving combines
the per-algorithm predictions into the served result. Models are plain
objects holding torch tensors; there is no Context or mesh.
"""

from __future__ import annotations

import abc
from typing import Any, List, Optional, Sequence

import torch


class Algorithm(abc.ABC):
    """The predict contract of one engine algorithm."""

    #: optional dataclass type for typed query parsing at the REST boundary
    query_class: Optional[type] = None

    @abc.abstractmethod
    def predict(self, model: Any, query: Any) -> Any:
        ...

    def batch_predict(self, model: Any, queries: Sequence[Any]) -> List[Any]:
        """Predictions for many queries; a host loop unless overridden."""
        return [self.predict(model, q) for q in queries]

    def prepare_serving_model(self, model: Any, device: torch.device) -> Any:
        """Called once per model when it binds to a serving surface: fix
        its placement on ``device``. Identity here."""
        return model


class Serving(abc.ABC):
    """Combines per-algorithm predictions into the served result."""

    def supplement(self, query: Any) -> Any:
        """Pre-predict query enrichment."""
        return query

    @abc.abstractmethod
    def serve(self, query: Any, predictions: Sequence[Any]) -> Any:
        ...


class FirstServing(Serving):
    """Serve the first algorithm's prediction."""

    def __init__(self, params: Any = None):
        pass

    def serve(self, query, predictions):
        return predictions[0]
