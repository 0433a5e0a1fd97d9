"""Batch views: the deprecated aggregation API of before 0.9, kept for
old code (the port's own copy of ``predictionio_tpu/data/view.py``).

:class:`EventSeq` wraps a list of events with predicate filtering and an
ordered fold a entity; :class:`BatchView` snapshots an app's events once
and answers filtered and aggregated queries. New code should use
``EventStoreFacade.aggregate_properties``.
"""

from __future__ import annotations

import warnings
from datetime import datetime
from typing import Callable, Dict, Iterable, List, Optional, TypeVar

from .datamap import DataMap
from .event import Event

T = TypeVar("T")


def _predicate(start_time: Optional[datetime] = None,
               until_time: Optional[datetime] = None,
               entity_type: Optional[str] = None,
               event: Optional[str] = None) -> Callable[[Event], bool]:
    """The conjunction of the given time, entity-type and event
    predicates."""

    def ok(e: Event) -> bool:
        if start_time is not None and e.event_time < start_time:
            return False
        if until_time is not None and not (e.event_time < until_time):
            return False
        if entity_type is not None and e.entity_type != entity_type:
            return False
        if event is not None and e.event != event:
            return False
        return True

    return ok


def data_map_aggregator():
    """The ``$set/$unset/$delete`` fold: (Optional[DataMap], Event) ->
    Optional[DataMap]."""

    def agg(acc: Optional[DataMap], e: Event) -> Optional[DataMap]:
        if e.event == "$set":
            base = acc.to_dict() if acc else {}
            base.update(e.properties.to_dict())
            return DataMap(base)
        if e.event == "$unset":
            base = acc.to_dict() if acc else {}
            for k in e.properties.to_dict():
                base.pop(k, None)
            return DataMap(base)
        if e.event == "$delete":
            return None
        return acc

    return agg


class EventSeq:
    """A list of events."""

    def __init__(self, events: Iterable[Event]):
        self.events: List[Event] = list(events)

    def filter(self, p: Optional[Callable[[Event], bool]] = None, *,
               start_time: Optional[datetime] = None,
               until_time: Optional[datetime] = None,
               entity_type: Optional[str] = None,
               event: Optional[str] = None) -> "EventSeq":
        pred = p if p is not None else _predicate(
            start_time, until_time, entity_type, event)
        return EventSeq([e for e in self.events if pred(e)])

    def aggregate_by_entity_ordered(
            self, init: T, op: Callable[[T, Event], T]) -> Dict[str, T]:
        """Fold each entity's events in event-time order."""
        grouped: Dict[str, List[Event]] = {}
        for e in sorted(self.events, key=lambda e: e.event_time):
            grouped.setdefault(e.entity_id, []).append(e)
        out: Dict[str, T] = {}
        for eid, evs in grouped.items():
            acc = init
            for e in evs:
                acc = op(acc, e)
            out[eid] = acc
        return out

    def __iter__(self):
        return iter(self.events)

    def __len__(self):
        return len(self.events)


class BatchView:
    """A snapshot of one app's events, read through ``ctx.event_store``."""

    def __init__(self, ctx, app_name: str,
                 start_time: Optional[datetime] = None,
                 until_time: Optional[datetime] = None):
        warnings.warn(
            "BatchView is deprecated; use "
            "EventStoreFacade.aggregate_properties instead",
            DeprecationWarning, stacklevel=2)
        self.events = EventSeq(ctx.event_store.find(
            app_name, start_time=start_time, until_time=until_time))

    def aggregate_properties(self, entity_type: str) -> Dict[str, DataMap]:
        """Each entity's current properties."""
        agg = data_map_aggregator()
        folded = self.events.filter(
            entity_type=entity_type).aggregate_by_entity_ordered(None, agg)
        return {k: v for k, v in folded.items() if v is not None}
