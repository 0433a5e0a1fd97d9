"""EntityMap: entity data keyed by dense ids (the port's own copy of
``predictionio_tpu/data/entitymap.py``).

:class:`EntityIdIxMap` is a string id <-> dense index map;
:class:`EntityMap` adds a payload an entity, extracted from its
aggregated properties (:func:`extract_entity_map`): the host side of a
feature table on the card keyed by the same dense ids.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Generic, Iterable, Optional, TypeVar

from .bimap import BiMap
from .datamap import PropertyMap

A = TypeVar("A")


class EntityIdIxMap:
    """String id <-> dense index; an int key reads the id back."""

    def __init__(self, id_to_ix: BiMap):
        self.id_to_ix = id_to_ix
        self.ix_to_id = id_to_ix.inverse

    @staticmethod
    def from_keys(keys: Iterable[str]) -> "EntityIdIxMap":
        return EntityIdIxMap(BiMap.string_int(keys))

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.id_to_ix[key]
        return self.ix_to_id[key]

    def __contains__(self, key) -> bool:
        return (key in self.id_to_ix if isinstance(key, str)
                else key in self.ix_to_id)

    def get(self, key, default=None):
        return (self.id_to_ix.get(key, default) if isinstance(key, str)
                else self.ix_to_id.get(key, default))

    def to_map(self) -> Dict[str, int]:
        return self.id_to_ix.to_dict()

    def __len__(self) -> int:
        return len(self.id_to_ix)

    def _first_keys(self, n: int) -> list:
        return list(itertools.islice(self.id_to_ix.keys(), n))

    def take(self, n: int) -> "EntityIdIxMap":
        return EntityIdIxMap(self.id_to_ix.take(self._first_keys(n)))


class EntityMap(EntityIdIxMap, Generic[A]):
    """An :class:`EntityIdIxMap` with a payload an entity."""

    def __init__(self, id_to_data: Dict[str, A],
                 id_to_ix: Optional[BiMap] = None):
        super().__init__(id_to_ix if id_to_ix is not None
                         else BiMap.string_int(id_to_data.keys()))
        self.id_to_data = dict(id_to_data)

    def data(self, key) -> A:
        if isinstance(key, str):
            return self.id_to_data[key]
        return self.id_to_data[self.ix_to_id[key]]

    def take(self, n: int) -> "EntityMap[A]":
        """The first ``n`` entities with their payloads."""
        keys = self._first_keys(n)
        return EntityMap({k: self.id_to_data[k] for k in keys},
                         self.id_to_ix.take(keys))


def extract_entity_map(store, app_name: str, entity_type: str,
                       extract: Callable[[PropertyMap], A],
                       channel_name: Optional[str] = None,
                       start_time=None, until_time=None,
                       required=None) -> EntityMap[A]:
    """Aggregate an entity type's properties through the event-store
    facade and map each entity's through ``extract``."""
    props = store.aggregate_properties(
        app_name, entity_type, channel_name=channel_name,
        start_time=start_time, until_time=until_time, required=required)
    return EntityMap({eid: extract(pm) for eid, pm in props.items()})
