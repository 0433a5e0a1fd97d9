"""JSON <-> typed objects at the REST boundary: the port's own copy of
``predictionio_tpu/utils/jsonutil.py`` (torch tensors in place of device
arrays).

Wire JSON parses into a template's query dataclass (camelCase keys and
declared aliases such as ``lambda`` accepted, unknown keys rejected), and
predictions render back to JSON.
"""

from __future__ import annotations

import dataclasses
import sys
import typing
from typing import Any, Mapping, Optional, Type

import numpy as np
import torch


def to_jsonable(obj: Any) -> Any:
    """Render dataclasses / numpy / torch values as JSON-compatible data."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if hasattr(obj, "to_json"):  # custom wire format wins over dataclass
        return obj.to_json()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, Mapping):
        return {str(k): to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [to_jsonable(x) for x in obj]
    if isinstance(obj, np.generic):
        # ptpu: allow[host-sync-in-hot-path] — a numpy scalar, on the host
        return obj.item()
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        # ptpu: allow[host-sync-in-hot-path] — the wire-JSON boundary:
        # an array or tensor becomes Python lists here, the one place
        # the query path serializes one, after its serve span
        return obj.tolist()
    return str(obj)


def from_jsonable(cls: Optional[Type], obj: Any) -> Any:
    """Parse wire JSON into ``cls`` when it is a dataclass; pass through
    otherwise. Unknown keys are rejected."""
    if cls is None or not dataclasses.is_dataclass(cls):
        return obj
    if not isinstance(obj, Mapping):
        raise ValueError(f"expected JSON object for {cls.__name__}, "
                         f"got {type(obj).__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    # declared wire aliases, e.g. ALSParams.reg carries
    # metadata={"aliases": ("lambda",)} for engine.json compatibility
    aliases = {a: f.name for f in dataclasses.fields(cls)
               for a in f.metadata.get("aliases", ())}
    normalized = {}
    for key, value in obj.items():
        name = key if key in fields else _snake_case(key)
        if name in aliases:
            name = aliases[name]
        if name not in fields and f"{name}_" in fields:
            name = f"{name}_"  # python-keyword fields, e.g. lambda -> lambda_
        if name not in fields:
            raise ValueError(f"unknown field(s) for {cls.__name__}: "
                             f"[{key!r}]")
        if name in normalized:
            raise ValueError(f"duplicate field for {cls.__name__}: {key!r}")
        normalized[name] = value
    kwargs = {}
    for name, value in normalized.items():
        ftype = _dataclass_type(fields[name].type, cls)
        kwargs[name] = (from_jsonable(ftype, value)
                        if ftype is not None else value)
    return cls(**kwargs)


def _snake_case(name: str) -> str:
    return "".join(f"_{ch.lower()}" if ch.isupper() else ch for ch in name)


def _dataclass_type(annotation: Any, owner: Type) -> Optional[Type]:
    """Resolve a field annotation to a dataclass type (string annotations
    and Optional[X] included); None when the field isn't one."""
    if isinstance(annotation, str):
        mod = sys.modules.get(owner.__module__)
        try:
            annotation = eval(annotation, vars(mod) if mod else {})  # noqa: S307
        except Exception:  # noqa: BLE001 — an unresolvable hint is no dataclass
            return None
    if typing.get_origin(annotation) is typing.Union:
        args = [a for a in typing.get_args(annotation) if a is not type(None)]
        if len(args) == 1:
            annotation = args[0]
    if isinstance(annotation, type) and dataclasses.is_dataclass(annotation):
        return annotation
    return None
