"""Sharded LRU + TTL cache with tag-based invalidation (the port's own
copy of ``predictionio_tpu/cache/lru.py``).

The storage primitive under the serving cache hierarchy:
``shards`` independent ``OrderedDict``s, each behind its own lock, so
concurrent HTTP worker threads don't serialize on one mutex. Every
entry carries a TTL (the staleness *bound* — the invalidation bus
usually clears entries long before it expires) and an optional set of
**tags**; :meth:`invalidate_tag` removes every entry carrying a tag in
O(entries-with-that-tag), which is how one ingested event for entity
``u42`` kills exactly the cached results that depended on ``u42``.

Keys are ``(namespace, payload)`` tuples by convention: the engine
server namespaces the query tier by engine-instance id (release arm),
so :meth:`flush` with a namespace wipes one arm without touching the
other.
"""

from __future__ import annotations

import sys
import time
from collections import OrderedDict
from typing import Any, Dict, Hashable, Iterable, Optional, Tuple

from ..concurrency import new_lock

__all__ = ["ShardedTTLCache", "approx_bytes"]


def approx_bytes(value: Any, _depth: int = 0) -> int:
    """Cheap recursive size estimate for cache byte accounting — close
    enough for capacity planning, never exact (depth-capped so a
    pathological nest can't turn a ``put`` into a traversal)."""
    n = sys.getsizeof(value, 64)
    if _depth >= 3:
        return n
    if isinstance(value, dict):
        for k, v in value.items():
            n += approx_bytes(k, _depth + 1) + approx_bytes(v, _depth + 1)
    elif isinstance(value, (list, tuple, set, frozenset)):
        for v in value:
            n += approx_bytes(v, _depth + 1)
    return n


class _Shard:
    __slots__ = ("lock", "entries", "tags", "bytes")

    def __init__(self) -> None:
        self.lock = new_lock("ShardedTTLCache.shard.lock")
        #: key → (value, expires_at, tags, cost_bytes); insertion order
        #: is recency order (move_to_end on hit)
        self.entries: "OrderedDict[Hashable, Tuple]" = OrderedDict()
        #: tag → set of keys carrying it
        self.tags: Dict[str, set] = {}
        self.bytes = 0


class ShardedTTLCache:
    """Thread-safe LRU+TTL map with tags and namespace flush."""

    def __init__(self, max_entries: int = 8192, ttl_sec: float = 30.0,
                 shards: int = 8,
                 clock=time.monotonic) -> None:
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = max_entries
        self.ttl_sec = float(ttl_sec)
        self._clock = clock
        self._shards = [_Shard() for _ in range(max(shards, 1))]
        #: per-shard capacity; ceil so shards*cap >= max_entries
        self._shard_cap = max(
            1, -(-max_entries // len(self._shards)))
        self._stats_lock = new_lock("ShardedTTLCache._stats_lock")
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._invalidations = 0
        self._expirations = 0

    def _shard(self, key: Hashable) -> _Shard:
        return self._shards[hash(key) % len(self._shards)]

    def _drop_locked(self, shard: _Shard, key: Hashable) -> None:
        value, exp, tags, cost = shard.entries.pop(key)
        shard.bytes -= cost
        for t in tags:
            keys = shard.tags.get(t)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del shard.tags[t]

    # -- read/write ---------------------------------------------------------
    def lookup(self, key: Hashable) -> Tuple[bool, Any]:
        """``(True, value)`` on a live hit, ``(False, None)`` otherwise
        (expired entries are dropped lazily here)."""
        shard = self._shard(key)
        with shard.lock:
            entry = shard.entries.get(key)
            if entry is not None:
                if self._clock() < entry[1]:
                    shard.entries.move_to_end(key)
                    with self._stats_lock:
                        self._hits += 1
                    return True, entry[0]
                self._drop_locked(shard, key)
                with self._stats_lock:
                    self._expirations += 1
        with self._stats_lock:
            self._misses += 1
        return False, None

    def put(self, key: Hashable, value: Any,
            tags: Iterable[str] = (),
            cost_bytes: Optional[int] = None,
            ttl_sec: Optional[float] = None) -> None:
        cost = approx_bytes(value) if cost_bytes is None else cost_bytes
        tags = tuple(tags)
        expires = self._clock() + (self.ttl_sec if ttl_sec is None
                                   else ttl_sec)
        shard = self._shard(key)
        evicted = 0
        with shard.lock:
            if key in shard.entries:
                self._drop_locked(shard, key)
            shard.entries[key] = (value, expires, tags, cost)
            shard.bytes += cost
            for t in tags:
                shard.tags.setdefault(t, set()).add(key)
            while len(shard.entries) > self._shard_cap:
                oldest = next(iter(shard.entries))
                self._drop_locked(shard, oldest)
                evicted += 1
        if evicted:
            with self._stats_lock:
                self._evictions += evicted

    # -- invalidation -------------------------------------------------------
    def invalidate_tag(self, tag: str) -> int:
        """Remove every entry tagged ``tag``; returns how many died."""
        removed = 0
        for shard in self._shards:
            with shard.lock:
                keys = shard.tags.pop(tag, None)
                if not keys:
                    continue
                for key in list(keys):
                    if key in shard.entries:
                        self._drop_locked(shard, key)
                        removed += 1
        if removed:
            with self._stats_lock:
                self._invalidations += removed
        return removed

    def invalidate_key(self, key: Hashable) -> bool:
        shard = self._shard(key)
        with shard.lock:
            if key in shard.entries:
                self._drop_locked(shard, key)
                removed = True
            else:
                removed = False
        if removed:
            with self._stats_lock:
                self._invalidations += 1
        return removed

    def flush(self, namespace: Optional[Any] = None) -> int:
        """Drop everything (``namespace=None``) or only the entries
        whose tuple key starts with ``namespace``."""
        removed = 0
        for shard in self._shards:
            with shard.lock:
                if namespace is None:
                    removed += len(shard.entries)
                    shard.entries.clear()
                    shard.tags.clear()
                    shard.bytes = 0
                else:
                    doomed = [k for k in shard.entries
                              if isinstance(k, tuple) and k
                              and k[0] == namespace]
                    for k in doomed:
                        self._drop_locked(shard, k)
                    removed += len(doomed)
        if removed:
            with self._stats_lock:
                self._invalidations += removed
        return removed

    # -- observability ------------------------------------------------------
    def __len__(self) -> int:
        return sum(len(s.entries) for s in self._shards)

    @property
    def bytes(self) -> int:
        return sum(s.bytes for s in self._shards)

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            hits, misses = self._hits, self._misses
            out = {
                "entries": len(self),
                "bytes": self.bytes,
                "maxEntries": self.max_entries,
                "ttlSec": self.ttl_sec,
                "hits": hits,
                "misses": misses,
                "evictions": self._evictions,
                "invalidations": self._invalidations,
                "expirations": self._expirations,
            }
        total = hits + misses
        out["hitRatio"] = (hits / total) if total else 0.0
        return out
