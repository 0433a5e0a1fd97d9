"""Custom model persistence: the ``PersistentModel`` protocol (the port
of ``predictionio_tpu/controller/persistent.py``).

A model class that manages its own durable form. ``save`` runs at train
time and the engine instance stores a :class:`~.base.PersistentModelManifest`
in place of the model; at deploy the manifest names the class, whose
``load`` classmethod rebuilds the model.

The stock layout is one ``<instanceId>-<algoIndex>.pkl`` per (instance,
algorithm) under ``$PIO_HOME/models/`` (or ``./.ptpu/models``), written
by :class:`LocalFileSystemPersistentModel`: a pickle of the user's own
class, with every tensor moved to the CPU first, which ``load_path``
reads back and checks for that class. The file is the user's: the port
unpickles it only when a manifest names that class.
"""

from __future__ import annotations

import abc
import copy
import importlib
import os
import pickle
from typing import Any, Optional

from .base import PersistentModelManifest

#: the JAX package's import name: a manifest naming one of its classes
#: cannot load here, since the port never imports that package
_JAX_PACKAGE = "predictionio_tpu"


def models_dir() -> str:
    """``$PIO_HOME/models`` (or ``./.ptpu/models``), created on demand."""
    root = os.environ.get("PIO_HOME") or os.path.join(".", ".ptpu")
    path = os.path.join(root, "models")
    os.makedirs(path, exist_ok=True)
    return path


def model_path(engine_instance_id: str, algo_index: int = 0) -> str:
    """The per-(instance, algorithm) path, without its extension."""
    return os.path.join(models_dir(), f"{engine_instance_id}-{algo_index}")


class PersistentModel(abc.ABC):
    """A self-persisting model. An algorithm whose ``train`` returns one
    persists it as a manifest (``Algorithm.make_persistent_model``)."""

    @abc.abstractmethod
    def save(self, engine_instance_id: str, algo_index: int = 0) -> bool:
        """Persist; return False to store the model in the blob instead."""

    @classmethod
    @abc.abstractmethod
    def load(cls, engine_instance_id: str,
             algo_index: int = 0) -> "PersistentModel":
        """Invert :meth:`save`."""


class LocalFileSystemPersistentModel(PersistentModel):
    """Pickle-to-local-disk base class: subclass it and it persists;
    override ``save``/``load`` for a layout of your own."""

    def persisted_location(self, engine_instance_id: str,
                           algo_index: int = 0) -> str:
        """The absolute file path, recorded in the manifest so deploy does
        not depend on ``PIO_HOME`` matching the training environment."""
        return os.path.abspath(
            model_path(engine_instance_id, algo_index) + ".pkl")

    def save(self, engine_instance_id: str, algo_index: int = 0) -> bool:
        from ..workflow.persistence import to_host

        path = self.persisted_location(engine_instance_id, algo_index)
        clone = copy.copy(self)
        clone.__dict__ = {k: to_host(v) for k, v in self.__dict__.items()}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(clone, f, protocol=4)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return True

    @classmethod
    def load_path(cls, path: str):
        with open(path, "rb") as f:
            model = pickle.load(f)
        if not isinstance(model, cls):
            raise TypeError(f"checkpoint at {path} holds "
                            f"{type(model).__name__}, expected "
                            f"{cls.__name__}")
        return model

    @classmethod
    def load(cls, engine_instance_id: str, algo_index: int = 0):
        return cls.load_path(
            os.path.abspath(model_path(engine_instance_id, algo_index)
                            + ".pkl"))


def manifest_for(model: PersistentModel, engine_instance_id: str,
                 algo_index: int) -> Optional[PersistentModelManifest]:
    """Run ``save``; on success, the manifest to store in place of the
    model."""
    if not model.save(engine_instance_id, algo_index):
        return None
    cls = type(model)
    locator = getattr(model, "persisted_location", None)
    return PersistentModelManifest(
        class_name=f"{cls.__module__}:{cls.__qualname__}",
        engine_instance_id=engine_instance_id, algo_index=algo_index,
        location=locator(engine_instance_id, algo_index) if locator else "")


def load_from_manifest(manifest: PersistentModelManifest) -> Any:
    """Resolve the manifest's class and call its loader: the recorded
    location when the class keeps the stock loader, its own ``load``
    otherwise. A class of the JAX package is refused."""
    mod_name, _, qualname = manifest.class_name.partition(":")
    if mod_name == _JAX_PACKAGE or mod_name.startswith(_JAX_PACKAGE + "."):
        raise ValueError(
            f"the manifest names {manifest.class_name}, a class of the JAX "
            f"package, which the port does not import; retrain with the "
            f"port or persist the model in the blob")
    obj: Any = importlib.import_module(mod_name)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    stock_load = (getattr(obj, "load", None) is not None
                  and obj.load.__func__
                  is LocalFileSystemPersistentModel.load.__func__)
    if manifest.location and stock_load:
        return obj.load_path(manifest.location)
    return obj.load(manifest.engine_instance_id, manifest.algo_index)
