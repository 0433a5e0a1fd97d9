"""DASE contracts: DataSource, Preparator, Algorithm and Serving (the
port of ``predictionio_tpu/controller/base.py``).

A data source reads training data, a preparator turns it into algorithm
input, an algorithm trains a model and predicts from it, and a serving
combines the per-algorithm predictions into the served result. Models
are plain objects holding torch tensors; there is no mesh.
"""

from __future__ import annotations

import abc
from typing import Any, List, Optional, Sequence, Tuple

import torch

from .context import Context

#: One evaluation fold: (training data, eval info, [(query, actual)]).
EvalFold = Tuple[Any, Any, List[Tuple[Any, Any]]]


class SanityCheck(abc.ABC):
    """Optional self-check hook on data and model objects; training calls
    it after read, prepare and train unless the context skips it."""

    @abc.abstractmethod
    def sanity_check(self) -> None:
        """Raise if the object is malformed (e.g. empty training data)."""


class DataSource(abc.ABC):
    """Reads the training data, and the folds an evaluation scores."""

    @abc.abstractmethod
    def read_training(self, ctx: Context) -> Any:
        ...

    def read_eval(self, ctx: Context) -> List[EvalFold]:
        """Folds of (training data, eval info, [(query, actual)]) for
        evaluation; default: none (the evaluator then raises)."""
        return []


class Preparator(abc.ABC):
    """Transforms training data into algorithm input."""

    @abc.abstractmethod
    def prepare(self, ctx: Context, training_data: Any) -> Any:
        ...


class IdentityPreparator(Preparator):
    """Pass-through preparator."""

    def __init__(self, params: Any = None):
        pass

    def prepare(self, ctx: Context, training_data):
        return training_data


class Algorithm(abc.ABC):
    """The train and predict contract of one engine algorithm."""

    #: optional dataclass type for typed query parsing at the REST boundary
    query_class: Optional[type] = None

    def train(self, ctx: Context, prepared_data: Any) -> Any:
        """A model trained on ``prepared_data`` on ``ctx.device``."""
        raise NotImplementedError(
            f"{type(self).__name__} serves models but does not train them")

    @abc.abstractmethod
    def predict(self, model: Any, query: Any) -> Any:
        ...

    def batch_predict(self, model: Any, queries: Sequence[Any]) -> List[Any]:
        """Predictions for many queries; a host loop unless overridden."""
        return [self.predict(model, q) for q in queries]

    def bind_serving(self, ctx: Context) -> None:
        """Called on the instances that will serve queries (the engine
        server's bind, the batch-predict job) with the serving context.
        Override to capture serving-time resources: the e-commerce
        template keeps ``ctx.event_store`` so its filter reads hit the
        deployed storage, not the process-wide one. A no-op here."""

    def make_persistent_model(self, model: Any, engine_instance_id: str,
                              algo_index: int) -> Any:
        """What the engine instance stores for ``model``: a
        :class:`~.persistent.PersistentModel` saves itself and is stored
        as its :class:`PersistentModelManifest`; any other model is
        stored in the blob as it is."""
        from .persistent import PersistentModel, manifest_for
        if isinstance(model, PersistentModel):
            manifest = manifest_for(model, engine_instance_id, algo_index)
            if manifest is not None:
                return manifest
        return model

    def load_persistent_model(self, ctx: Context, stored: Any) -> Any:
        """Invert :meth:`make_persistent_model` at deploy time."""
        from .persistent import load_from_manifest
        if isinstance(stored, PersistentModelManifest) and stored.class_name:
            return load_from_manifest(stored)
        return stored

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


class AverageServing(Serving):
    """Average numeric predictions."""

    def __init__(self, params: Any = None):
        pass

    def serve(self, query, predictions):
        return sum(predictions) / len(predictions)


class PersistentModelManifest:
    """Stored in place of a model whose algorithm persisted it itself;
    records how to find it again. ``class_name`` (``module:QualName``)
    names a :class:`~.persistent.PersistentModel` whose ``load`` inverts
    the save; ``location`` and ``extra`` serve a custom
    ``load_persistent_model``."""

    def __init__(self, class_name: str = "", engine_instance_id: str = "",
                 algo_index: int = 0, location: str = "",
                 extra: Optional[dict] = None):
        self.class_name = class_name
        self.engine_instance_id = engine_instance_id
        self.algo_index = algo_index
        self.location = location
        self.extra = extra or {}

    def __repr__(self):
        return (f"PersistentModelManifest({self.class_name!r}, "
                f"{self.engine_instance_id!r}, {self.algo_index}, "
                f"{self.location!r})")
