"""Schemaless property maps: the port's own copy of
``predictionio_tpu/data/datamap.py``.

A ``DataMap`` wraps a dict of JSON values with typed accessors; a
``PropertyMap`` adds the first/last updated times of property
aggregation.
"""

from __future__ import annotations

import json
from datetime import datetime
from typing import Any, Iterator, Mapping, Optional, Type, TypeVar

T = TypeVar("T")

_JSON_TYPES = (type(None), bool, int, float, str, list, dict)


class DataMapError(KeyError):
    """Raised when a required field is missing or has the wrong type."""


class DataMap(Mapping[str, Any]):
    """An immutable, schemaless map of JSON values with typed ``get``.

    Unlike the reference's json4s AST, values are plain Python JSON values
    (None/bool/int/float/str/list/dict); ``get(name, type)`` performs the
    typed extraction the reference does with manifests.
    """

    __slots__ = ("_fields",)

    def __init__(self, fields: Optional[Mapping[str, Any] | str] = None):
        if fields is None:
            fields = {}
        elif isinstance(fields, str):
            fields = json.loads(fields)
        elif isinstance(fields, DataMap):
            fields = fields._fields
        if not isinstance(fields, Mapping):
            raise DataMapError(f"DataMap requires a JSON object, got {type(fields)}")
        self._fields = dict(fields)

    # -- Mapping protocol --------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        try:
            return self._fields[key]
        except KeyError:
            raise DataMapError(f"The field {key} is required.")

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __contains__(self, key: object) -> bool:
        return key in self._fields

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DataMap):
            return self._fields == other._fields
        if isinstance(other, Mapping):
            return self._fields == dict(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(json.dumps(self._fields, sort_keys=True, default=str))

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"

    # -- typed access ------------------------------------------------------
    def get(self, name: str, cls: Optional[Type[T]] = None, default: Any = ...) -> Any:
        """Typed field access: ``get("a", int)``; raises :class:`DataMapError`
        when the field is absent (unless ``default`` is given) or not
        convertible to ``cls``."""
        if name not in self._fields:
            if default is not ...:
                return default
            raise DataMapError(f"The field {name} is required.")
        v = self._fields[name]
        if cls is None:
            return v
        return _coerce(name, v, cls)

    def get_opt(self, name: str, cls: Optional[Type[T]] = None) -> Optional[T]:
        """Optional typed access; returns None when absent or null."""
        v = self._fields.get(name)
        if v is None:
            return None
        return _coerce(name, v, cls) if cls is not None else v

    def get_list(self, name: str, cls: Optional[Type[T]] = None) -> list:
        v = self.get(name)
        if not isinstance(v, list):
            raise DataMapError(f"The field {name} is not a list.")
        if cls is None:
            return list(v)
        return [_coerce(name, x, cls) for x in v]

    # -- algebra (used by aggregation) -------------------------------------
    def union(self, other: "DataMap | Mapping[str, Any]") -> "DataMap":
        """Right-biased merge (reference ``DataMap.++``)."""
        merged = dict(self._fields)
        merged.update(dict(other))
        return DataMap(merged)

    def without(self, keys) -> "DataMap":
        """Remove keys (reference ``DataMap.--``)."""
        drop = set(keys)
        return DataMap({k: v for k, v in self._fields.items() if k not in drop})

    def keys(self):
        return self._fields.keys()

    def to_dict(self) -> dict:
        return dict(self._fields)

    def to_json(self) -> str:
        return json.dumps(self._fields, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "DataMap":
        return DataMap(json.loads(s))


def _coerce(name: str, v: Any, cls: Type[T]) -> T:
    if cls is float and isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)  # type: ignore[return-value]
    if cls is int and isinstance(v, bool):
        raise DataMapError(f"The field {name} is not an int.")
    if cls is int and isinstance(v, float) and v.is_integer():
        return int(v)  # type: ignore[return-value]
    if cls is bool and not isinstance(v, bool):
        raise DataMapError(f"The field {name} is not a bool.")
    if not isinstance(v, cls):
        raise DataMapError(f"The field {name} has type {type(v).__name__}, "
                           f"expected {cls.__name__}.")
    return v


class PropertyMap(DataMap):
    """A :class:`DataMap` with aggregation bookkeeping: when the entity's
    properties were first and last updated (reference
    ``data/.../storage/PropertyMap.scala``)."""

    __slots__ = ("first_updated", "last_updated")

    def __init__(self, fields: Optional[Mapping[str, Any] | str],
                 first_updated: datetime, last_updated: datetime):
        super().__init__(fields)
        self.first_updated = first_updated
        self.last_updated = last_updated

    def __eq__(self, other: object) -> bool:
        if isinstance(other, PropertyMap):
            return (self._fields == other._fields
                    and self.first_updated == other.first_updated
                    and self.last_updated == other.last_updated)
        return super().__eq__(other)

    def __hash__(self) -> int:
        return hash((super().__hash__(), self.first_updated, self.last_updated))

    def __repr__(self) -> str:
        return (f"PropertyMap({self._fields!r}, first_updated="
                f"{self.first_updated!r}, last_updated={self.last_updated!r})")

    def to_datamap(self) -> DataMap:
        return DataMap(self._fields)
