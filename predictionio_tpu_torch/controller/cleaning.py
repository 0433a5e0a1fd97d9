"""SelfCleaningDataSource: compaction of an app's event log (the port's
own copy of ``predictionio_tpu/controller/cleaning.py``).

``EventWindow(duration, remove_duplicates, compress_properties)``: keep
the events of a recent window (``$set``/``$unset`` always survive),
compress an entity's ``$set``/``$unset`` stream into one ``$set``, drop
duplicates (everything but the id and the times equal, the earliest
kept), and rewrite the stored log in place
(:meth:`SelfCleaningDataSource.clean_persisted_events`, ``wipe``).
Compression groups by (entityType, entityId).
"""

from __future__ import annotations

import json
import logging
import re
from dataclasses import dataclass
from datetime import datetime, timedelta
from typing import Dict, Iterable, List, Optional, Tuple

from ..data.datamap import DataMap
from ..data.event import Event, utcnow

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class EventWindow:
    """What the cleaning keeps. ``duration`` accepts ``"<n> <unit>"`` (seconds/minutes/hours/days/
    weeks, singular or plural) or a bare number of seconds."""
    duration: Optional[str] = None
    remove_duplicates: bool = False
    compress_properties: bool = False


_UNITS = {"second": 1, "minute": 60, "hour": 3600, "day": 86400,
          "week": 604800}


def parse_duration(s: str) -> timedelta:
    s = s.strip()
    m = re.fullmatch(r"([0-9.]+)\s*([a-zA-Z]+)?", s)
    if not m:
        raise ValueError(f"cannot parse duration {s!r}")
    n = float(m.group(1))
    unit = (m.group(2) or "second").lower().rstrip("s")
    if unit not in _UNITS:
        raise ValueError(f"unknown duration unit in {s!r}")
    return timedelta(seconds=n * _UNITS[unit])


def _is_set_event(e: Event) -> bool:
    return e.event in ("$set", "$unset")


def _compress_group(events: List[Event]) -> Event:
    """Replay one entity's ``$set``/``$unset`` stream (ascending time)
    into a single ``$set`` carrying the final property state."""
    props: Dict = {}
    last = events[-1]
    for e in events:
        if e.event == "$set":
            props.update(e.properties.to_dict())
        else:  # $unset
            for k in e.properties.to_dict():
                props.pop(k, None)
    return last.copy(event="$set", properties=DataMap(props),
                     event_id=None)


def _dedup_key(e: Event) -> Tuple:
    """Everything except eventId, eventTime and creationTime."""
    return (e.event, e.entity_type, e.entity_id, e.target_entity_type,
            e.target_entity_id,
            json.dumps(e.properties.to_dict(), sort_keys=True, default=str),
            tuple(e.tags), e.pr_id)


class SelfCleaningDataSource:
    """Mixin for DataSources. Subclasses set ``app_name`` and override
    ``event_window``; call :meth:`clean_events` on what they read, or
    :meth:`clean_persisted_events` to rewrite storage in place."""

    app_name: str = ""

    @property
    def event_window(self) -> Optional[EventWindow]:
        return None

    # -- pure transformations ----------------------------------------------
    def filter_window(self, events: Iterable[Event],
                      now: Optional[datetime] = None) -> List[Event]:
        """Keep the events inside the window; property events always
        survive."""
        ew = self.event_window
        events = list(events)
        if ew is None or ew.duration is None:
            return events
        cutoff = (now or utcnow()) - parse_duration(ew.duration)
        return [e for e in events
                if e.event_time > cutoff or _is_set_event(e)]

    def compress_properties(self, events: Iterable[Event]) -> List[Event]:
        """One compacted ``$set`` a (entityType, entityId)."""
        groups: Dict[Tuple[str, str], List[Event]] = {}
        rest: List[Event] = []
        for e in sorted(events, key=lambda e: e.event_time):
            if _is_set_event(e):
                groups.setdefault((e.entity_type, e.entity_id),
                                  []).append(e)
            else:
                rest.append(e)
        return [_compress_group(g) for g in groups.values()] + rest

    def remove_duplicates(self, events: Iterable[Event]) -> List[Event]:
        """Keep the earliest of each set of duplicates."""
        seen: Dict[Tuple, Event] = {}
        for e in sorted(events, key=lambda e: e.event_time):
            seen.setdefault(_dedup_key(e), e)
        return list(seen.values())

    def clean_events(self, events: Iterable[Event],
                     now: Optional[datetime] = None) -> List[Event]:
        """The window filter, then compression and deduplication when
        the window asks for them."""
        ew = self.event_window
        out = self.filter_window(events, now=now)
        if ew is None:
            return out
        if ew.compress_properties:
            out = self.compress_properties(out)
        if ew.remove_duplicates:
            out = self.remove_duplicates(out)
        return out

    # -- persisted rewrite ------------------------------------------------
    def clean_persisted_events(self, ctx,
                               now: Optional[datetime] = None) -> int:
        """Replace the app's stored events with their cleaned form.
        Returns the number of events removed. No-op without a window."""
        if self.event_window is None:
            return 0
        store = ctx.event_store
        app_name = self.app_name or ctx.app_name
        app_id, _ = store.resolve(app_name)
        original = list(store.find(app_name))
        cleaned = self.clean_events(original, now=now)
        keep_ids = {e.event_id for e in cleaned if e.event_id}
        # cleaning only transforms events from `original`, so anything
        # without an id is newly minted (e.g. a compacted $set)
        new_events = [e for e in cleaned if not e.event_id]
        removed = 0
        for e in original:
            if e.event_id and e.event_id not in keep_ids:
                ctx.storage.events().delete(e.event_id, app_id)
                removed += 1
        if new_events:
            ctx.storage.events().insert_batch(
                [e.copy(event_id=None) for e in new_events], app_id)
        log.info("clean_persisted_events: removed %d, wrote %d",
                 removed, len(new_events))
        return removed

    def wipe(self, ctx, new_events: Iterable[Event],
             event_ids_to_remove: Iterable[str]) -> None:
        """Insert ``new_events`` and delete ``event_ids_to_remove``."""
        app_name = self.app_name or ctx.app_name
        app_id, _ = ctx.event_store.resolve(app_name)
        ctx.storage.events().insert_batch(
            [e.copy(event_id=None) for e in new_events], app_id)
        for eid in event_ids_to_remove:
            if eid:
                ctx.storage.events().delete(eid, app_id)
