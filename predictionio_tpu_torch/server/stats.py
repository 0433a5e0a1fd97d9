"""The event server's per-app ingest statistics (``/stats.json``, the
port's copy of ``StatsCollector`` in ``predictionio_tpu/server/stats.py``):
per-app counts keyed by (entityType, targetEntityType, event) and by
status code, for the current hour, with the previous hour kept after the
cutoff.

Left out (``ROADMAP.md``, "decided not to port"): ``RecompileSentinel``,
which counts XLA compiles.
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Dict, Optional, Tuple

from ..concurrency import new_lock
from ..data.event import Event, isoformat_millis

EteKey = Tuple[str, Optional[str], str]  # (entityType, targetEntityType, event)


class Stats:
    """One accumulation window (the reference's ``Stats`` class)."""

    def __init__(self, start_time: datetime):
        self.start_time = start_time
        self.end_time: Optional[datetime] = None
        self.status_code_count: Dict[Tuple[int, int], int] = {}
        self.ete_count: Dict[Tuple[int, EteKey], int] = {}

    def update(self, app_id: int, status: int, event: Event) -> None:
        sk = (app_id, status)
        self.status_code_count[sk] = self.status_code_count.get(sk, 0) + 1
        ek = (app_id, (event.entity_type, event.target_entity_type, event.event))
        self.ete_count[ek] = self.ete_count.get(ek, 0) + 1

    def cutoff(self, end_time: datetime) -> None:
        self.end_time = end_time

    def snapshot(self, app_id: int) -> dict:
        return {
            "startTime": isoformat_millis(self.start_time),
            "endTime": (isoformat_millis(self.end_time)
                        if self.end_time else None),
            "basic": [
                {"key": {"entityType": k[0], "targetEntityType": k[1],
                         "event": k[2]},
                 "value": v}
                for (aid, k), v in sorted(self.ete_count.items())
                if aid == app_id],
            "statusCode": [
                {"key": code, "value": v}
                for (aid, code), v in sorted(self.status_code_count.items())
                if aid == app_id],
        }


def _hour_floor(t: datetime) -> datetime:
    return t.replace(minute=0, second=0, microsecond=0)


class StatsCollector:
    """Thread-safe hourly-rolling pair of windows (``StatsActor`` role)."""

    def __init__(self):
        self._lock = new_lock("StatsCollector._lock")
        now = datetime.now(timezone.utc)
        self._current = Stats(_hour_floor(now))
        self._previous: Optional[Stats] = None

    def _roll(self, now: datetime) -> None:
        hour = _hour_floor(now)
        if hour > self._current.start_time:
            self._current.cutoff(hour)
            self._previous = self._current
            self._current = Stats(hour)

    def bookkeeping(self, app_id: int, status: int, event: Event) -> None:
        now = datetime.now(timezone.utc)
        with self._lock:
            self._roll(now)
            self._current.update(app_id, status, event)

    def bookkeeping_bulk(self, app_id: int, status: int, batch) -> None:
        """Columnar-block bookkeeping: one ``np.unique`` over the coded
        columns replaces ``n`` per-event dict updates — the window's
        counts come out exactly as if every event had been booked
        individually."""
        import numpy as np

        n = batch.n
        if not n:
            return
        keys, counts = np.unique(np.stack(
            [batch.entity_type, batch.target_type, batch.event], axis=1),
            axis=0, return_counts=True)
        d = batch.dicts
        now = datetime.now(timezone.utc)
        with self._lock:
            self._roll(now)
            cur = self._current
            sk = (app_id, status)
            cur.status_code_count[sk] = \
                cur.status_code_count.get(sk, 0) + int(n)
            # ptpu: allow[host-sync-in-hot-path,blocking-under-lock] —
            # numpy arrays of the block's host columns, not tensors: no
            # card is waited on. `keys` holds the block's DISTINCT
            # triples (bounded by the app's event vocabulary), not its
            # n rows
            for (et, tt, ev), c in zip(keys.tolist(), counts.tolist()):
                ek = (app_id, (
                    d.entity_types.values[et],
                    d.target_types.values[tt] if tt >= 0 else None,
                    d.event_names.values[ev]))
                cur.ete_count[ek] = cur.ete_count.get(ek, 0) + int(c)

    def get(self, app_id: int) -> dict:
        with self._lock:
            self._roll(datetime.now(timezone.utc))
            result = self._current.snapshot(app_id)
            if self._previous is not None:
                result["prev"] = self._previous.snapshot(app_id)
            return result
