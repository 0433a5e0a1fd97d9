"""The hot-entity tier: pin the Zipf head's rows on the card (the port's
own copy of ``predictionio_tpu/cache/hot.py``).

Recommendation traffic is skewed: a few percent of users send most
queries. This tier counts serves per entity and periodically **pins** the
top-K hottest through a caller-supplied ``pin_fn``; for the ALS template
that gathers those users' factor rows into one small ``[capacity, rank]``
table resident on the serving device
(``templates/recommendation.py::ALSAlgorithm.pin_hot_entities``), and a
known-hot user's query is ranked from it.

The tier never blocks serving: ``record`` and ``lookup`` are dict
lookups; the refresh (ranking the counts, gathering the rows) runs on a
background thread, and the pinned map is swapped whole. ``flush()``
(every rebind: promote, rollback, reload) drops the pins AND the counts,
so a new model never serves rows pinned from the old one.

Two things differ from the JAX package's tier:

- the refresh thread is kept and :meth:`close` joins it, so a closed
  server leaves no thread behind;
- a failed refresh is logged AND counted (``refreshErrors``, ``lastError``
  in :meth:`stats`): on the card a pin gathers rows and launches the
  top-k kernel, and a failed build or launch must show. ``pinnedStale``
  counts the handles a caller found pinned against another binding
  (:meth:`note_stale`).
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Dict, Optional, Tuple

from ..concurrency import new_lock

log = logging.getLogger(__name__)

__all__ = ["HotEntityTier"]

#: pin_fn signature: (entity_keys) -> ({entity: handle}, pinned_bytes)
PinFn = Callable[[list], Tuple[Dict[str, Any], int]]

#: longest a waiting refresh, or close(), waits for the one in flight
REFRESH_WAIT_S = 120.0


class HotEntityTier:
    def __init__(self, pin_fn: PinFn, capacity: int = 512,
                 refresh_every: int = 256) -> None:
        self.pin_fn = pin_fn
        self.capacity = max(capacity, 1)
        self.refresh_every = max(refresh_every, 1)
        self._lock = new_lock("HotEntityTier._lock")
        self._counts: Dict[str, int] = {}
        self._pinned: Dict[str, Any] = {}
        self._bytes = 0
        self._records = 0
        self._hits = 0
        self._misses = 0
        self._refreshes = 0
        self._refresh_errors = 0
        self._last_error: Optional[str] = None
        self._stale = 0
        self._generation = 0  # bumped by flush(); stale refreshes drop
        self._refreshing = False
        self._refresh_done: Optional[threading.Event] = None
        #: keys invalidated while a refresh was in flight: its rows for
        #: them were gathered before the change, so it must not pin them
        self._dirty: set = set()
        #: refresh threads started and maybe still running (close joins)
        self._threads: list = []
        self._closed = False

    # -- hot path -----------------------------------------------------------
    def record(self, key: str) -> None:
        """Count one serve for ``key``; every ``refresh_every`` records
        a background re-pin is scheduled."""
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + 1
            self._records += 1
            due = self._records % self.refresh_every == 0
            # bound the stat map: keep the head, drop the long tail
            if len(self._counts) > 8 * self.capacity:
                keep = sorted(self._counts.items(),
                              key=lambda kv: kv[1],
                              reverse=True)[:2 * self.capacity]
                self._counts = dict(keep)
        if due:
            self.refresh(wait=False)

    def lookup(self, key: str) -> Optional[Any]:
        """The pinned handle for ``key``, or None (counts hit/miss)."""
        with self._lock:
            handle = self._pinned.get(key)
            if handle is not None:
                self._hits += 1
            else:
                self._misses += 1
        return handle

    def peek(self, key: str) -> Optional[Any]:
        """The pinned handle for ``key`` without counting a hit or miss
        (inspection, not serving)."""
        with self._lock:
            return self._pinned.get(key)

    def note_stale(self) -> None:
        """Count a handle the caller found pinned against another binding
        than the one it serves (a pin that raced a rebind); the caller
        serves through the full table instead."""
        with self._lock:
            self._stale += 1

    # -- refresh ------------------------------------------------------------
    def refresh(self, wait: bool = True) -> None:
        """Re-rank the counts and re-pin the top-K. ``wait=False`` runs
        it on a background thread (the serving-path mode); at most one
        refresh runs at a time, and ``wait=True`` against an in-flight
        refresh blocks until THAT one lands instead of skipping. After
        :meth:`close` nothing starts."""
        start = False
        with self._lock:
            if self._closed:
                return
            if not self._refreshing:
                self._refreshing = True
                self._refresh_done = threading.Event()
                self._dirty = set()
                start = True
            done = self._refresh_done
        if start:
            if wait:
                self._refresh_now()
            else:
                t = threading.Thread(target=self._refresh_now, daemon=True,
                                     name="hot-tier-refresh")
                with self._lock:
                    self._threads = [w for w in self._threads
                                     if w.is_alive()] + [t]
                t.start()
        elif wait and done is not None:
            done.wait(timeout=REFRESH_WAIT_S)

    def _refresh_now(self) -> None:
        try:
            with self._lock:
                gen = self._generation
                top = sorted(self._counts.items(), key=lambda kv: kv[1],
                             reverse=True)[:self.capacity]
                keys = [k for k, _ in top]
            if not keys:
                return
            handles, nbytes = self.pin_fn(keys)
            with self._lock:
                if gen != self._generation:
                    return  # flushed (rebind) while we were pinning
                self._pinned = {k: h for k, h in handles.items()
                                if k not in self._dirty}
                self._bytes = int(nbytes)
                self._refreshes += 1
        except Exception as e:  # noqa: BLE001 — counted and logged: a
            log.exception("hot-entity pin refresh failed")  # failed pin
            with self._lock:                     # loses the fast path,
                self._refresh_errors += 1        # never breaks serving
                self._last_error = f"{type(e).__name__}: {e}"
        finally:
            with self._lock:
                self._refreshing = False
                self._dirty = set()
                if self._refresh_done is not None:
                    self._refresh_done.set()

    def invalidate(self, keys) -> int:
        """Drop the pinned handles for ``keys`` only: their factor rows
        changed under the pin (a streaming fold-in rewrote them), so a
        pinned serve would read the OLD rows. A refresh in flight gathered
        its rows before the change, so it pins none of ``keys`` either.
        The counts survive: the entities are as hot as ever and the next
        refresh re-pins them from the updated table."""
        dropped = 0
        with self._lock:
            for k in keys:
                if self._refreshing:
                    self._dirty.add(k)
                if self._pinned.pop(k, None) is not None:
                    dropped += 1
        return dropped

    def flush(self) -> int:
        """Drop pins and counts (model rebind / operator flush)."""
        with self._lock:
            n = len(self._pinned)
            self._pinned = {}
            self._counts = {}
            self._bytes = 0
            self._generation += 1
        return n

    def close(self, timeout: float = REFRESH_WAIT_S) -> None:
        """Start no refresh from now on and join the one in flight.
        Idempotent."""
        with self._lock:
            self._closed = True
            threads, self._threads = self._threads, []
        for t in threads:
            if t is not threading.current_thread():
                t.join(timeout)

    # -- observability ------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            hits, misses = self._hits, self._misses
            out = {
                "entries": len(self._pinned),
                "bytes": self._bytes,
                "capacity": self.capacity,
                "hits": hits,
                "misses": misses,
                "evictions": 0,
                "invalidations": self._generation,
                "records": self._records,
                "refreshes": self._refreshes,
                "trackedEntities": len(self._counts),
                "refreshErrors": self._refresh_errors,
                "lastError": self._last_error,
                "pinnedStale": self._stale,
            }
        total = hits + misses
        out["hitRatio"] = (hits / total) if total else 0.0
        return out
