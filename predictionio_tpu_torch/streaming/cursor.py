"""Durable per-consumer event-log cursor, persisted through EVENTDATA (the
port of ``predictionio_tpu/streaming/cursor.py``; the record is the JAX
package's, so either package resumes the other's cursor).

The streaming trainer tails the event log; its position must
survive restarts WITH the log it indexes — a cursor stored anywhere
else (a file, a model blob) can desync from the events under backup/
restore or environment cloning. So the cursor itself is an event: a
``$set`` on the reserved ``pio_stream`` entity type, written with a
FIXED explicit ``event_id`` so every save replaces the previous one
(every backend's ``insert`` upserts by id). Training reads filter
``entity_type="user"`` and the fold-in scan filters to its configured
entity type, so cursor records never leak into either.

Position semantics: the event log is totally ordered by
``(event_time, event_id-at-that-time)``. The cursor stores the last
consumed event's time plus the ids of every consumed event SHARING
that timestamp; catch-up reads ``find(start_time=position)`` (the
inclusive side) and drops the seen ids — so a restart replays exactly
the unconsumed suffix: no loss, no double-apply. (Fold-in is
idempotent anyway — rows re-solve from full history — but the cursor
contract holds without leaning on that.)

Known bound: events ingested with an ``eventTime`` EARLIER than the
cursor position (explicit backfills) are behind the cursor and are
picked up by the next full retrain, not the stream.
"""

from __future__ import annotations

import logging
from datetime import datetime, timezone
from typing import List, Optional, Sequence

from ..data.event import Event, to_millis
from ..data.storage.base import ANY, EventFilter

log = logging.getLogger(__name__)

__all__ = ["EventCursor", "CURSOR_ENTITY_TYPE"]

#: reserved entity type carrying cursor records (data/event.py
#: whitelists it next to ``pio_pr``)
CURSOR_ENTITY_TYPE = "pio_stream"

#: epoch start — a fresh cursor consumes the whole log
_EPOCH = datetime(1970, 1, 1, tzinfo=timezone.utc)


class EventCursor:
    """One consumer's durable position in one app's event log.

    Not thread-safe by itself: the owning trainer serializes
    consume→advance→save on its own loop thread.
    """

    def __init__(self, storage, app_id: int, consumer: str,
                 channel_id: Optional[int] = None):
        self.storage = storage
        self.app_id = int(app_id)
        self.channel_id = channel_id
        self.consumer = consumer
        self.position: datetime = _EPOCH
        #: ids of consumed events whose event_time == position (the
        #: tie-break set; stays tiny — ms-resolution timestamps)
        self.seen: List[str] = []
        #: block-mode row watermark: how many NON-cursor storage-order
        #: rows this consumer has already taken (see
        #: :meth:`pending_block`); independent of the event-wise
        #: time position — a consumer uses one mode or the other
        self.block_rows = 0
        self.consumed_total = 0
        self.saves = 0
        self.load()

    # -- persistence --------------------------------------------------------
    @property
    def cursor_event_id(self) -> str:
        return f"pio:stream:cursor:{self.consumer}"

    def load(self) -> bool:
        """Restore position from the persisted cursor record; False
        when none exists (fresh consumer → start of log)."""
        rec = self.storage.events().get(self.cursor_event_id, self.app_id,
                                        self.channel_id)
        if rec is None:
            return False
        props = rec.properties
        try:
            # NB: DataMap.get's second positional is a TYPE, not a
            # default — keyword `default` is the optional-field form
            self.position = datetime.fromtimestamp(
                float(props["positionMillis"]) / 1000.0, tz=timezone.utc)
            self.seen = [str(s) for s in
                         (props.get("seen", default=None) or [])]
            self.block_rows = int(props.get("blockRows", default=0))
            self.consumed_total = int(props.get("consumed", default=0))
        except (KeyError, TypeError, ValueError) as e:
            log.error("corrupt stream cursor %s: %s; restarting from "
                      "log start", self.cursor_event_id, e)
            self.position, self.seen, self.block_rows = _EPOCH, [], 0
            return False
        return True

    def save(self) -> None:
        """Upsert the cursor record (fixed event_id → replace). The
        cursor event's own event_time is pinned to the epoch so it can
        never enter its own catch-up range."""
        from ..data.datamap import DataMap

        self.storage.events().insert(
            Event(event="$set", entity_type=CURSOR_ENTITY_TYPE,
                  entity_id=self.consumer,
                  properties=DataMap(
                      {"positionMillis": to_millis(self.position),
                       "seen": list(self.seen),
                       "blockRows": self.block_rows,
                       "consumed": self.consumed_total}),
                  event_time=_EPOCH,
                  event_id=self.cursor_event_id),
            self.app_id, self.channel_id)
        self.saves += 1

    # -- reads --------------------------------------------------------------
    def pending(self, event_names: Optional[Sequence[str]] = None,
                entity_type: Optional[str] = None,
                limit: Optional[int] = None) -> List[Event]:
        """Unconsumed events after the cursor, oldest first. The
        ``start_time`` filter is inclusive, so ties at the cursor
        timestamp come back and the seen set drops the consumed ones.
        ``limit`` bounds the batch (the backend caps its scan; ties
        the cursor has partially consumed cost a few extra rows)."""
        filt = EventFilter(
            start_time=None if self.position == _EPOCH else self.position,
            entity_type=entity_type,
            event_names=list(event_names) if event_names else None,
            target_entity_type=ANY, target_entity_id=ANY,
            limit=None if limit is None else int(limit) + len(self.seen))
        seen = set(self.seen)
        out = []
        for e in self.storage.events().find(self.app_id, self.channel_id,
                                            filt):
            if e.entity_type == CURSOR_ENTITY_TYPE:
                continue  # never consume cursor records
            if e.event_id in seen:
                continue
            out.append(e)
            if limit is not None and len(out) >= limit:
                break
        return out

    def lag(self, event_names: Optional[Sequence[str]] = None,
            entity_type: Optional[str] = None, cap: int = 10_000) -> int:
        """How many unconsumed events sit behind the cursor (scan
        capped at ``cap`` — a status signal, not an exact count at
        extreme backlogs)."""
        return len(self.pending(event_names=event_names,
                                entity_type=entity_type, limit=cap))

    # -- block reads --------------------------------------------------------
    def pending_block(self, float_props: Sequence[str] = ("rating",),
                      with_props: bool = False):
        """Block-granularity consumption (the columnar-ingest
        counterpart of :meth:`pending`): the whole unconsumed suffix as
        one zero-copy :class:`~..data.columnar.ColumnarBatch` — no
        per-event ``Event`` objects on the hot fold-in path.

        Position is a ROW WATERMARK counted over NON-cursor rows of the
        backend's storage-order projection (``ordered=False``): the
        cursor record itself is an ``INSERT OR REPLACE`` upsert whose
        row can churn position on every save, so it is masked out
        BEFORE the watermark is applied — its movement can never shift
        which event rows are "new". On an append-only log in storage
        order (SQLite's ``seq``), each row is returned exactly once
        regardless of event timestamps; backends whose bulk projection
        is time-ordered inherit the same append-order bound as
        :meth:`pending`.

        Consume, then ``advance_block(batch.n)`` + :meth:`save`."""
        import numpy as np

        full = self.storage.events().find_columnar(
            self.app_id, self.channel_id, EventFilter(),
            float_props=tuple(float_props), ordered=False,
            with_props=with_props)
        code = full.dicts.entity_types.index.get(CURSOR_ENTITY_TYPE)
        if code is None:
            idx = np.arange(full.n)
        else:
            idx = np.flatnonzero(full.entity_type != code)
        if self.block_rows > len(idx):
            # deletes/compaction shrank the log under the watermark —
            # clamp; the dropped suffix is covered by the next retrain
            log.warning("block cursor %s: watermark %d > %d log rows; "
                        "clamping", self.consumer, self.block_rows,
                        len(idx))
            self.block_rows = len(idx)
        return full.take(idx[self.block_rows:], with_props=with_props)

    def advance_block(self, n_rows: int) -> None:
        """Move the row watermark past ``n_rows`` consumed block rows."""
        self.block_rows += int(n_rows)
        self.consumed_total += int(n_rows)

    # -- writes -------------------------------------------------------------
    def advance(self, events: Sequence[Event]) -> None:
        """Move past ``events`` (consumed, oldest-first). Events at a
        NEW maximum timestamp reset the tie-break set; events tied
        with the current position extend it."""
        if not events:
            return
        max_t = max(e.event_time for e in events)
        if max_t > self.position:
            self.position = max_t
            self.seen = [e.event_id for e in events
                         if e.event_time == max_t and e.event_id]
        else:
            # all ties at (or behind) the current position: extend
            at = [e.event_id for e in events
                  if e.event_time == self.position and e.event_id]
            self.seen = list(dict.fromkeys(self.seen + at))
        self.consumed_total += len(events)

    def status(self) -> dict:
        return {
            "consumer": self.consumer,
            "position": (None if self.position == _EPOCH
                         else self.position.isoformat()),
            "seenAtPosition": len(self.seen),
            "blockRows": self.block_rows,
            "consumed": self.consumed_total,
            "saves": self.saves,
        }
