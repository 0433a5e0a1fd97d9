"""Typed per-controller parameters from engine variant JSON (the port's
copy of ``predictionio_tpu/controller/params.py``).

Params are plain dataclasses; a controller class is built from its
params object, or from nothing if it takes none.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Type

from ..utils.jsonutil import from_jsonable


class Params:
    """Optional marker base for controller params; any dataclass works."""


@dataclasses.dataclass(frozen=True)
class EmptyParams(Params):
    pass


def params_to_json(params: Any) -> dict:
    """A params object as a JSON dict (dataclass fields, or the dict
    itself)."""
    if params is None:
        return {}
    if dataclasses.is_dataclass(params) and not isinstance(params, type):
        return dataclasses.asdict(params)
    if isinstance(params, Mapping):
        return dict(params)
    raise TypeError(f"cannot serialize params of type {type(params)}")


def params_from_json(params_cls: Optional[Type], obj: Mapping[str, Any]) -> Any:
    """Build a params object from a JSON dict. With no declared class the
    dict passes through. Dataclass params accept camelCase keys and their
    declared aliases (``lambda`` for ``reg``) and reject unknown keys."""
    if params_cls is None:
        return dict(obj)
    if dataclasses.is_dataclass(params_cls):
        try:
            return from_jsonable(params_cls, obj)
        except ValueError as e:
            raise ValueError(
                f"invalid params for {params_cls.__name__}: {e}") from e
    return params_cls(**obj)


def instantiate(controller_cls: Type, params: Any):
    """Construct a controller from its params: a 1-arg (params)
    constructor if it has one, else 0-arg."""
    sig = inspect.signature(controller_cls.__init__)
    n_required = sum(
        1 for name, p in sig.parameters.items()
        if name != "self" and p.default is inspect.Parameter.empty
        and p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                       inspect.Parameter.POSITIONAL_ONLY))
    if n_required >= 1:
        return controller_cls(params)
    if params not in (None, {}, EmptyParams()) and len(sig.parameters) > 1:
        return controller_cls(params)
    return controller_cls()


@dataclasses.dataclass(frozen=True)
class EngineParams:
    """Named params for every DASE slot. ``algorithms`` is a list of
    (name, params)."""

    datasource: Tuple[str, Any] = ("", None)
    preparator: Tuple[str, Any] = ("", None)
    algorithms: Sequence[Tuple[str, Any]] = (("", None),)
    serving: Tuple[str, Any] = ("", None)

    def copy(self, **changes) -> "EngineParams":
        return dataclasses.replace(self, **changes)

    def to_json(self) -> dict:
        """The engine.json variant shape of these params (the
        evaluator's result JSON and its best-variant file)."""
        def one(pair):
            name, p = pair
            return {"name": name, "params": params_to_json(p)}

        return {
            "dataSourceParams": one(self.datasource),
            "preparatorParams": one(self.preparator),
            "algorithmsParams": [one(a) for a in self.algorithms],
            "servingParams": one(self.serving),
        }


def engine_params_from_variant(
        variant: Mapping[str, Any],
        datasource_params_cls: Optional[Type] = None,
        preparator_params_cls: Optional[Type] = None,
        algorithm_params_classes: Optional[Dict[str, Type]] = None,
        serving_params_cls: Optional[Type] = None) -> EngineParams:
    """Extract :class:`EngineParams` from an ``engine.json``-shaped
    variant. Each slot is ``{"name": ..., "params": {...}}`` (name
    optional); ``algorithms`` is a list of such entries. A ``*_cls`` may
    be one params class or a name -> class map."""

    def one(key: str, cls) -> Tuple[str, Any]:
        node = variant.get(key)
        if not node:
            return ("", None)
        name = node.get("name", "")
        if isinstance(cls, Mapping):
            cls = cls.get(name)
        return (name, params_from_json(cls, node.get("params", {})))

    algos: List[Tuple[str, Any]] = []
    for node in variant.get("algorithms", []):
        name = node.get("name", "")
        cls = (algorithm_params_classes or {}).get(name)
        algos.append((name, params_from_json(cls, node.get("params", {}))))
    return EngineParams(
        datasource=one("datasource", datasource_params_cls),
        preparator=one("preparator", preparator_params_cls),
        algorithms=tuple(algos) if algos else (("", None),),
        serving=one("serving", serving_params_cls))


def load_variant(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)
