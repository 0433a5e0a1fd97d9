"""Property aggregation: replaying ``$set/$unset/$delete`` into entity
state (the port's own copy of ``predictionio_tpu/data/aggregation.py``).

Two aggregators with the JAX package's semantics:

- the commutative ``EventOp`` monoid: per-field latest-time merge of
  ``$set`` fields, latest ``$unset`` time per field, latest ``$delete``
  time. It is order-insensitive and associative, so shards of the log may
  be aggregated apart and merged (:func:`partial_aggregate`,
  :func:`merge_aggregates`); the storage reads use it;
- the time-ordered fold of one entity's events
  (:func:`aggregate_properties_single`), for single-entity lookups.

Everything here is host Python over events or columnar rows; nothing
runs on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Dict, Iterable, Optional, Tuple

from .datamap import DataMap, PropertyMap
from .event import Event, from_millis, to_millis

#: Event names that drive property aggregation.
AGGREGATION_EVENTS = ("$set", "$unset", "$delete")


@dataclass(frozen=True)
class EventOp:
    """Commutative, associative summary of an entity's property events.

    ``set_fields`` maps field name -> (value, set-time-millis); ``set_t`` is
    the latest ``$set`` time (a ``$set`` with no fields still moves it);
    ``unset_fields`` maps field name -> latest unset-time; ``delete_t`` is
    the latest ``$delete`` time. ``merge`` is the monoid's combine.
    """

    set_fields: Dict[str, Tuple[Any, int]] = field(default_factory=dict)
    set_t: Optional[int] = None
    unset_fields: Dict[str, int] = field(default_factory=dict)
    delete_t: Optional[int] = None
    first_updated: Optional[datetime] = None
    last_updated: Optional[datetime] = None

    @staticmethod
    def from_event(e: Event) -> "EventOp":
        return EventOp.from_parts(e.event, e.properties.to_dict(),
                                  e.event_time_millis, e.event_time)

    @staticmethod
    def from_parts(event: str, properties: Dict[str, Any], t: int,
                   event_time: datetime) -> "EventOp":
        """Build from raw parts, so the columnar path builds no
        ``Event``."""
        if event == "$set":
            return EventOp(
                set_fields={k: (v, t) for k, v in properties.items()},
                set_t=t, first_updated=event_time, last_updated=event_time)
        if event == "$unset":
            return EventOp(
                unset_fields={k: t for k in properties.keys()},
                first_updated=event_time, last_updated=event_time)
        if event == "$delete":
            return EventOp(
                delete_t=t, first_updated=event_time,
                last_updated=event_time)
        return EventOp()

    def merge(self, other: "EventOp") -> "EventOp":
        """Order-insensitive combine: per-field latest write wins."""
        set_fields = dict(self.set_fields)
        for k, (v, t) in other.set_fields.items():
            if k not in set_fields or t > set_fields[k][1]:
                set_fields[k] = (v, t)
        unset_fields = dict(self.unset_fields)
        for k, t in other.unset_fields.items():
            if k not in unset_fields or t > unset_fields[k]:
                unset_fields[k] = t
        return EventOp(
            set_fields=set_fields,
            set_t=_max_opt(self.set_t, other.set_t),
            unset_fields=unset_fields,
            delete_t=_max_opt(self.delete_t, other.delete_t),
            first_updated=_min_time(self.first_updated, other.first_updated),
            last_updated=_max_time(self.last_updated, other.last_updated),
        )

    def to_property_map(self) -> Optional[PropertyMap]:
        """The entity's current properties, or None where it does not
        exist (never ``$set``, or deleted at or after the latest ``$set``).
        A field survives unless unset at or after its set time, or the
        entity was deleted at or after the time the field was set."""
        if self.set_t is None:
            return None
        if self.delete_t is not None and self.delete_t >= self.set_t:
            return None
        fields = {}
        for k, (v, t) in self.set_fields.items():
            if k in self.unset_fields and self.unset_fields[k] >= t:
                continue
            if self.delete_t is not None and self.delete_t >= t:
                continue
            fields[k] = v
        assert self.first_updated is not None and self.last_updated is not None
        return PropertyMap(fields, self.first_updated, self.last_updated)


def _max_opt(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None:
        return b
    if b is None:
        return a
    return max(a, b)


def _min_time(a: Optional[datetime], b: Optional[datetime]
              ) -> Optional[datetime]:
    if a is None:
        return b
    if b is None:
        return a
    return b if to_millis(b) < to_millis(a) else a


def _max_time(a: Optional[datetime], b: Optional[datetime]
              ) -> Optional[datetime]:
    if a is None:
        return b
    if b is None:
        return a
    return b if to_millis(b) > to_millis(a) else a


def _materialize(ops: Dict[str, EventOp]) -> Dict[str, PropertyMap]:
    out: Dict[str, PropertyMap] = {}
    for entity_id, op in ops.items():
        pm = op.to_property_map()
        if pm is not None:
            out[entity_id] = pm
    return out


def partial_aggregate(events: Iterable[Event]) -> Dict[str, EventOp]:
    """Per-shard partial aggregation: entity id -> its merged op."""
    ops: Dict[str, EventOp] = {}
    for e in events:
        op = EventOp.from_event(e)
        prev = ops.get(e.entity_id)
        ops[e.entity_id] = prev.merge(op) if prev is not None else op
    return ops


def aggregate_properties(events: Iterable[Event]) -> Dict[str, PropertyMap]:
    """Per-entity current properties of an event stream under the
    monoid. Shard-safe: shards aggregated with :func:`partial_aggregate`
    and combined with :func:`merge_aggregates` give the same result."""
    return _materialize(partial_aggregate(events))


def aggregate_from_columnar(batch) -> Dict[str, PropertyMap]:
    """Monoid aggregation over a columnar batch of ``$set/$unset/$delete``
    rows; the caller has already pushed the entity-type and time filters
    down as masks, so only the surviving rows pay a JSON parse."""
    names = batch.dicts.event_names.values
    entity_values = batch.dicts.entity_ids.values
    ops: Dict[str, EventOp] = {}
    for i in range(batch.n):
        t = int(batch.event_time[i])
        op = EventOp.from_parts(names[batch.event[i]], batch.props_json(i),
                                t, from_millis(t))
        eid = entity_values[batch.entity_id[i]]
        prev = ops.get(eid)
        ops[eid] = prev.merge(op) if prev is not None else op
    return _materialize(ops)


def merge_aggregates(a: Dict[str, EventOp],
                     b: Dict[str, EventOp]) -> Dict[str, EventOp]:
    """Combine two shards' partial aggregates."""
    out = dict(a)
    for k, op in b.items():
        prev = out.get(k)
        out[k] = prev.merge(op) if prev is not None else op
    return out


def aggregate_properties_single(events: Iterable[Event]
                                ) -> Optional[PropertyMap]:
    """Time-ordered fold for one entity: ``$set`` merges right-biased,
    ``$unset`` drops keys, ``$delete`` resets existence; the entity
    exists only if the fold ends with a defined map."""
    dm: Optional[DataMap] = None
    first: Optional[datetime] = None
    last: Optional[datetime] = None
    for e in sorted(events, key=lambda ev: ev.event_time_millis):
        if e.event not in AGGREGATION_EVENTS:
            continue
        if e.event == "$set":
            dm = e.properties if dm is None else dm.union(e.properties)
        elif e.event == "$unset":
            dm = None if dm is None else dm.without(e.properties.keys())
        elif e.event == "$delete":
            dm = None
        first = _min_time(first, e.event_time)
        last = _max_time(last, e.event_time)
    if dm is None:
        return None
    assert first is not None and last is not None
    return PropertyMap(dm.to_dict(), first, last)


def aggregate_properties_ordered(events: Iterable[Event]
                                 ) -> Dict[str, PropertyMap]:
    """The time-ordered fold, grouped by entity."""
    by_entity: Dict[str, list] = {}
    for e in events:
        by_entity.setdefault(e.entity_id, []).append(e)
    out: Dict[str, PropertyMap] = {}
    for entity_id, evs in by_entity.items():
        pm = aggregate_properties_single(evs)
        if pm is not None:
            out[entity_id] = pm
    return out
