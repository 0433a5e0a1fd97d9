"""Data layer: the event model, property maps, aggregation, the storage
registry and its backends (``storage``), and the stores templates read."""

from .aggregation import (
    EventOp,
    aggregate_properties,
    aggregate_properties_ordered,
    aggregate_properties_single,
)
from .bimap import BiMap
from .datamap import DataMap, DataMapError, PropertyMap
from .entitymap import EntityIdIxMap, EntityMap, extract_entity_map
from .event import SPECIAL_EVENTS, Event, EventValidationError

__all__ = [
    "DataMap",
    "DataMapError",
    "PropertyMap",
    "Event",
    "EventValidationError",
    "SPECIAL_EVENTS",
    "BiMap",
    "EntityIdIxMap",
    "EntityMap",
    "extract_entity_map",
    "EventOp",
    "aggregate_properties",
    "aggregate_properties_ordered",
    "aggregate_properties_single",
]
