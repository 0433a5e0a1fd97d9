"""The event model: the port's own copy of ``predictionio_tpu/data/event.py``.

Events are immutable dataclasses whose properties are schemaless
:class:`~predictionio_tpu_torch.data.datamap.DataMap` values, with
millisecond-precision UTC timestamps; :func:`validate_event` enforces the
same rules as the JAX package, so an event one package accepts the other
accepts too.
"""

from __future__ import annotations

import os
import uuid
from dataclasses import dataclass, field, replace
from datetime import datetime, timezone
from typing import Any, List, Mapping, Optional, Sequence

import numpy as np

from .datamap import DataMap

#: Reserved events that mutate entity properties.
SPECIAL_EVENTS = frozenset({"$set", "$unset", "$delete"})


def utcnow() -> datetime:
    """Current time, timezone-aware UTC, truncated to millisecond precision."""
    now = datetime.now(timezone.utc)
    return now.replace(microsecond=(now.microsecond // 1000) * 1000)


def to_millis(t: datetime) -> int:
    """Epoch milliseconds of a (timezone-aware) datetime."""
    if t.tzinfo is None:
        t = t.replace(tzinfo=timezone.utc)
    return int(t.timestamp() * 1000)


def from_millis(ms: int) -> datetime:
    return datetime.fromtimestamp(ms / 1000.0, tz=timezone.utc)


class EventValidationError(ValueError):
    """Raised when an event fails the framework's validation rules."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise EventValidationError(msg)


@dataclass(frozen=True)
class Event:
    """A single immutable record in the append-only event log.

    Field set matches the reference's ``Event`` case class
    (``data/.../storage/Event.scala:42-53``): name, entity, optional target
    entity, schemaless properties, event time, tags, optional prediction id
    (for the serving feedback loop) and creation time.
    """

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: Optional[str] = None
    target_entity_id: Optional[str] = None
    properties: DataMap = field(default_factory=DataMap)
    event_time: datetime = field(default_factory=utcnow)
    tags: Sequence[str] = ()
    pr_id: Optional[str] = None
    creation_time: datetime = field(default_factory=utcnow)
    event_id: Optional[str] = None

    def __post_init__(self) -> None:
        if not isinstance(self.properties, DataMap):
            object.__setattr__(self, "properties", DataMap(self.properties))
        if isinstance(self.tags, list):
            object.__setattr__(self, "tags", tuple(self.tags))
        validate_event(self)

    # -- convenience -------------------------------------------------------
    @property
    def event_time_millis(self) -> int:
        return to_millis(self.event_time)

    def copy(self, **changes: Any) -> "Event":
        return replace(self, **changes)

    def is_special(self) -> bool:
        return self.event in SPECIAL_EVENTS

    # -- JSON wire format (API-compatible with the reference event server) --
    def to_json(self) -> dict:
        """Render in the REST API's JSON schema (camelCase keys, ISO times),
        mirroring the reference's ``EventJson4sSupport.APISerializer``."""
        out: dict[str, Any] = {
            "event": self.event,
            "entityType": self.entity_type,
            "entityId": self.entity_id,
        }
        if self.event_id is not None:
            out["eventId"] = self.event_id
        if self.target_entity_type is not None:
            out["targetEntityType"] = self.target_entity_type
        if self.target_entity_id is not None:
            out["targetEntityId"] = self.target_entity_id
        if len(self.properties) > 0:
            out["properties"] = self.properties.to_dict()
        out["eventTime"] = isoformat_millis(self.event_time)
        if self.tags:
            out["tags"] = list(self.tags)
        if self.pr_id is not None:
            out["prId"] = self.pr_id
        out["creationTime"] = isoformat_millis(self.creation_time)
        return out

    @staticmethod
    def from_json(obj: Mapping[str, Any]) -> "Event":
        """Parse the REST API's JSON schema into an :class:`Event`."""
        try:
            event = obj["event"]
            entity_type = obj["entityType"]
            entity_id = obj["entityId"]
        except KeyError as e:
            raise EventValidationError(f"missing required field {e.args[0]!r}")
        for k, v in (("event", event), ("entityType", entity_type),
                     ("entityId", entity_id)):
            if not isinstance(v, str):
                raise EventValidationError(f"field {k!r} must be a string")
        event_time = obj.get("eventTime")
        creation_time = obj.get("creationTime")
        return Event(
            event=event,
            entity_type=entity_type,
            entity_id=entity_id,
            target_entity_type=obj.get("targetEntityType"),
            target_entity_id=obj.get("targetEntityId"),
            properties=DataMap(obj.get("properties") or {}),
            event_time=parse_iso(event_time) if event_time else utcnow(),
            tags=tuple(obj.get("tags") or ()),
            pr_id=obj.get("prId"),
            creation_time=parse_iso(creation_time) if creation_time else utcnow(),
            event_id=obj.get("eventId"),
        )


def isoformat_millis(t: datetime) -> str:
    """``YYYY-MM-DDTHH:MM:SS.mmmZ`` in UTC (a naive time is read as UTC).
    Formatted field by field, which is the same text as ``strftime`` for
    four-digit years at a fifth of its cost (an export of millions of
    events formats two times an event)."""
    if t.tzinfo is not timezone.utc:
        if t.tzinfo is None:
            t = t.replace(tzinfo=timezone.utc)
        t = t.astimezone(timezone.utc)
    if t.year < 1000:
        return (t.strftime("%Y-%m-%dT%H:%M:%S.")
                + f"{t.microsecond // 1000:03d}Z")
    return (f"{t.year:04d}-{t.month:02d}-{t.day:02d}T{t.hour:02d}:"
            f"{t.minute:02d}:{t.second:02d}.{t.microsecond // 1000:03d}Z")


def parse_iso(s: str) -> datetime:
    """Parse ISO-8601; accepts 'Z' suffix and fractional seconds."""
    if not isinstance(s, str):
        raise EventValidationError(f"invalid time value: {s!r}")
    raw = s.strip()
    if raw.endswith(("Z", "z")):
        raw = raw[:-1] + "+00:00"
    try:
        t = datetime.fromisoformat(raw)
    except ValueError:
        raise EventValidationError(f"invalid ISO-8601 time: {s!r}")
    if t.tzinfo is None:
        t = t.replace(tzinfo=timezone.utc)
    return t


#: Entity types the framework itself writes: prediction feedback
#: entities (``pio_pr``) and the streaming trainer's consumer cursors
#: (``pio_stream``). Kept equal to the JAX package's, so validation agrees.
BUILTIN_ENTITY_TYPES = frozenset({"pio_pr", "pio_stream"})

#: Reserved-prefix property names the framework itself stamps onto
#: events (``pio_traceparent``: the ingest request's trace context).
BUILTIN_PROPERTY_NAMES = frozenset({"pio_traceparent"})

#: Reserved name prefix for entity types and property names.
RESERVED_PREFIX = "pio_"


def _is_reserved(name: str) -> bool:
    return name.startswith(("$", RESERVED_PREFIX))


def validate_event(e: Event) -> None:
    """Enforce the reference's event validation rules
    (``data/.../storage/Event.scala:112-160``): non-empty names/ids; target
    entity type/id specified together; reserved ``$``-prefix only for special
    events; ``$unset`` requires non-empty properties; special events take no
    target entity; ``pio_`` prefix reserved for built-in entity types and
    property names. Each message is formatted only when its rule fails:
    every stored event passes here again when it is read back.
    """
    _require(bool(e.event), "event must not be empty")
    _require(bool(e.entity_type), "entityType must not be empty")
    _require(bool(e.entity_id), "entityId must not be empty")
    _require(e.target_entity_type is None or bool(e.target_entity_type),
             "targetEntityType must not be empty string")
    _require(e.target_entity_id is None or bool(e.target_entity_id),
             "targetEntityId must not be empty string")
    _require((e.target_entity_type is None) == (e.target_entity_id is None),
             "targetEntityType and targetEntityId must be specified together")
    if _is_reserved(e.event) and e.event not in SPECIAL_EVENTS:
        raise EventValidationError(
            f"{e.event!r} is not a supported reserved event name")
    if e.event == "$unset":
        _require(len(e.properties) > 0, "$unset event requires properties")
    if e.event in SPECIAL_EVENTS and (e.target_entity_type is not None
                                      or e.target_entity_id is not None):
        raise EventValidationError(
            f"reserved event {e.event} cannot have targetEntity")
    if _is_reserved(e.entity_type) \
            and e.entity_type not in BUILTIN_ENTITY_TYPES:
        raise EventValidationError(
            f"entityType {e.entity_type!r} is not allowed; "
            f"{RESERVED_PREFIX!r} is a reserved prefix")
    if e.target_entity_type is not None \
            and _is_reserved(e.target_entity_type) \
            and e.target_entity_type not in BUILTIN_ENTITY_TYPES:
        raise EventValidationError(
            f"targetEntityType {e.target_entity_type!r} is not allowed; "
            f"{RESERVED_PREFIX!r} is a reserved prefix")
    for k in e.properties.keys():
        if _is_reserved(k) and k not in BUILTIN_PROPERTY_NAMES:
            raise EventValidationError(
                f"property {k!r} is not allowed; "
                f"{RESERVED_PREFIX!r} is a reserved prefix")


def new_event_id() -> str:
    """Generate a unique event id (hex UUID4, like the reference's backends)."""
    return uuid.uuid4().hex


def new_event_ids(n: int) -> List[str]:
    """``n`` ids like :func:`new_event_id` (hex UUID4: random, with the
    version and variant bits set) from one ``os.urandom`` call, not one
    call an id."""
    raw = np.frombuffer(os.urandom(16 * n), np.uint8).reshape(n, 16).copy()
    raw[:, 6] = (raw[:, 6] & 0x0F) | 0x40
    raw[:, 8] = (raw[:, 8] & 0x3F) | 0x80
    h = raw.tobytes().hex()
    return [h[k:k + 32] for k in range(0, 32 * n, 32)]
