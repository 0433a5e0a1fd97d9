"""Overlap accounting for the staged serving pipeline (the port's copy
of ``predictionio_tpu/obs/overlap.py``, with the same arithmetic).

Splitting the serving batch path into assemble, dispatch and readback
stages is meant to keep the card computing WHILE the host parses and
supplements the next batch and serializes the previous one.
:class:`OverlapTracker` accrues wall-clock into per-track busy counters,
and into an overlap counter whenever the device track and at least one
host track are active together. The engine server shows the fractions in
``/status.json``'s ``pipeline`` block (``deviceIdleFraction``,
``overlapFraction``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict

#: the accelerator track; every other track name counts as host work
DEVICE_TRACK = "device"


class OverlapTracker:
    """O(1)-per-transition wall-clock accounting over named activity
    tracks. ``enter(track)``/``exit(track)`` bracket activity (tracks
    are counted, so concurrent batches nest); between any two
    transitions the elapsed time accrues into every active track's
    busy counter, and into the overlap counter when ``"device"`` and
    any host track were both active. The wall-clock origin is the
    FIRST ``enter`` — idle time before traffic ever arrived does not
    dilute the fractions."""

    def __init__(self, time_fn=time.monotonic):
        self._time = time_fn
        self._lock = threading.Lock()
        self._active: Dict[str, int] = {}
        self._busy: Dict[str, float] = {}
        self._overlap = 0.0
        self._t0 = None
        self._last = None

    # called only with self._lock held (enter, exit, snapshot)
    def _accrue(self, now: float) -> None:
        if self._last is None:
            return
        dt = now - self._last
        if dt <= 0:
            return
        device = self._active.get(DEVICE_TRACK, 0) > 0
        host = any(n > 0 for t, n in self._active.items()
                   if t != DEVICE_TRACK)
        for t, n in self._active.items():
            if n > 0:
                self._busy[t] = self._busy.get(t, 0.0) + dt
        if device and host:
            self._overlap += dt

    def enter(self, track: str) -> int:
        """Mark ``track`` active; returns the PRIOR active count (a
        dispatch stage uses ``enter("device") > 0`` as "this launch
        overlapped an in-flight batch")."""
        with self._lock:
            now = self._time()
            if self._t0 is None:
                self._t0 = now
            self._accrue(now)
            self._last = now
            prev = self._active.get(track, 0)
            self._active[track] = prev + 1
            return prev

    def exit(self, track: str) -> None:
        with self._lock:
            now = self._time()
            self._accrue(now)
            self._last = now
            self._active[track] = max(self._active.get(track, 0) - 1, 0)

    def active(self, track: str) -> int:
        with self._lock:
            return self._active.get(track, 0)

    def snapshot(self) -> dict:
        """Cumulative view: wall seconds since first activity, per-track
        busy seconds, device busy/idle fractions, and the overlap
        fraction (device ∧ host active). In-progress intervals are
        folded in up to now."""
        with self._lock:
            now = self._time()
            self._accrue(now)
            self._last = now
            wall = (now - self._t0) if self._t0 is not None else 0.0
            busy = dict(self._busy)
            overlap = self._overlap
        device_busy = busy.get(DEVICE_TRACK, 0.0)
        return {
            "wall_sec": wall,
            "busy_sec": busy,
            "device_busy_sec": device_busy,
            "device_busy_fraction": (device_busy / wall) if wall > 0
            else 0.0,
            "device_idle_fraction": (1.0 - device_busy / wall)
            if wall > 0 else 1.0,
            "overlap_sec": overlap,
            "overlap_fraction": (overlap / wall) if wall > 0 else 0.0,
        }

    def device_idle_fraction(self) -> float:
        return self.snapshot()["device_idle_fraction"]

    def overlap_fraction(self) -> float:
        return self.snapshot()["overlap_fraction"]
