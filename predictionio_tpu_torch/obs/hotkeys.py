"""Space-Saving heavy-hitter sketch: hot-key telemetry in O(k) memory
(the port's copy of ``predictionio_tpu/obs/hotkeys.py``).

Which entity ids dominate the query stream. An exact per-key counter is
unbounded on a server that lives for weeks; the Space-Saving sketch
(Metwally, Agrawal, El Abbadi 2005) keeps exactly ``k`` monitored keys
and, on a miss, EVICTS the current minimum and adopts its count as the
newcomer's floor, so every key whose true frequency exceeds ``N/k`` is
monitored, with a per-key overestimate bound (``error``) beside it.
``record`` is O(k): a linear min-scan over ``k`` entries (128 by
default), far below one JSON parse on the query path. ``merge_items`` folds
another sketch's export in: the fleet's merge of per-replica sketches.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional

__all__ = ["SpaceSaving", "mount_hot_key_metrics"]


class SpaceSaving:
    """Thread-safe Space-Saving top-K sketch over string keys."""

    __slots__ = ("capacity", "_counts", "_errors", "_total", "_lock")

    def __init__(self, capacity: int = 128) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._counts: Dict[str, float] = {}
        self._errors: Dict[str, float] = {}
        self._total = 0.0
        self._lock = threading.Lock()

    def record(self, key: Optional[str], count: float = 1.0) -> None:
        """Count one occurrence of ``key`` (None/empty ignored — the
        query had no entity, nothing to place)."""
        if not key:
            return
        with self._lock:
            self._total += count
            self._insert_locked(str(key), count, 0.0)

    def _insert_locked(self, k: str, count: float,
                       error: float) -> None:
        if k in self._counts:
            self._counts[k] += count
            self._errors[k] = self._errors.get(k, 0.0) + error
            return
        if len(self._counts) < self.capacity:
            self._counts[k] = count
            self._errors[k] = error
            return
        # evict the minimum-count key; the newcomer inherits its
        # count as a floor (the Space-Saving overestimate) and
        # records that floor as its error bound
        victim = min(self._counts, key=self._counts.__getitem__)
        floor = self._counts.pop(victim)
        self._errors.pop(victim, None)
        self._counts[k] = floor + count
        self._errors[k] = floor + error

    @property
    def total(self) -> float:
        """Observations recorded (including evicted keys' mass)."""
        with self._lock:
            return self._total

    def top(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        """Hottest keys, descending: ``[{"key", "count", "error"}]``.
        ``count`` may overestimate by at most ``error``; the true
        frequency is in ``[count - error, count]``."""
        with self._lock:
            items = sorted(self._counts.items(),
                           key=lambda kv: kv[1], reverse=True)
            errors = dict(self._errors)
        if n is not None:
            items = items[:n]
        return [{"key": k, "count": c, "error": errors.get(k, 0.0)}
                for k, c in items]

    def merge_items(self, items: Iterable[Dict[str, Any]],
                    total: float = 0.0) -> None:
        """Fold another sketch's :meth:`top` export into this one: shared
        keys sum counts AND errors (both bounds stay valid); a new key
        goes in through the usual evict-the-minimum path, its incoming
        error on top of the eviction floor."""
        with self._lock:
            self._total += float(total)
            for item in items:
                k = str(item.get("key") or "")
                if not k:
                    continue
                self._insert_locked(k,
                                    float(item.get("count", 0.0)),
                                    float(item.get("error", 0.0)))

    def snapshot(self, n: int = 16) -> Dict[str, Any]:
        """The ``hotKeys`` block of ``/status.json`` (and of the fleet
        scrape)."""
        return {"capacity": self.capacity, "total": self.total,
                "top": self.top(n)}

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._errors.clear()
            self._total = 0.0


def mount_hot_key_metrics(reg: Any, sketch: SpaceSaving,
                          top_n: int = 10,
                          metric_name: str = "pio_hot_keys") -> None:
    """Expose the sketch's current top-N as ``pio_hot_keys{rank,key}``
    gauge lines via a render-time collector. A collector (not a gauge
    family) because the hot set CHURNS: family children are permanent,
    so yesterday's hot key would linger as a stale zero series forever;
    a collector re-emits only the current top-N each scrape."""
    from .registry import escape_label_value, format_value

    def collect():
        top = sketch.top(top_n)
        if not top:
            return []
        lines = [f"# HELP {metric_name} Space-Saving heavy-hitter "
                 f"counts of query entity ids (top-{top_n}; count "
                 f"overestimates by at most the paired error bound)",
                 f"# TYPE {metric_name} gauge"]
        for rank, item in enumerate(top, start=1):
            key = escape_label_value(item["key"])
            lines.append(
                f'{metric_name}{{key="{key}",rank="{rank}"}} '
                f'{format_value(item["count"])}')
        return lines

    reg.register_collector(collect)
