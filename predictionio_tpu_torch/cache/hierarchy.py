"""The serving cache hierarchy: query tier + feature tier + hot tier (the
port's own copy of ``predictionio_tpu/cache/hierarchy.py``).

One :class:`ServingCache` per
:class:`~predictionio_tpu_torch.server.engineserver.QueryServer`. The
tiers, in the order a query meets them:

1. **query** — exact-key result cache consulted before the batch paths:
   a hot query returns its JSON straight from memory, skipping
   parse, supplement, the card and serve entirely. Keys are
   ``(namespace, canonical-query-JSON)``; the namespace is the serving
   binding (the engine-instance id), so the stable and candidate release
   arms never serve each other's results, and a rebind flushes per arm.
2. **feature** — serving-time event-store reads (the e-commerce
   template's seen/unavailable/weighted/recent lookups) cached under a
   shorter TTL and invalidated per entity by the bus.
3. **hot** — the pinned-row tier (:class:`~.hot.HotEntityTier`),
   refreshed from the serves it counts.

Entries carry entity **tags** (``"user:u42"``,
``"constraint:weightedItems"``); the invalidation bus maps one
ingested event to exactly the tagged entries it contradicts. A
``constraint`` entity ``$set`` (catalog-wide blacklist/weights) flushes
the whole query tier — every cached result may now be wrong.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, Optional, Tuple

from ..concurrency import new_lock
from .bus import InvalidationBus, default_bus
from .hot import HotEntityTier, PinFn
from .lru import ShardedTTLCache
from .singleflight import SingleFlight

__all__ = ["ServingCache", "canonical_key", "entity_tag"]


def canonical_key(query_json: Any) -> str:
    """Stable exact-match key for a query payload: key order must not
    matter (two clients sending the same query differently ordered are
    the same query)."""
    try:
        return json.dumps(query_json, sort_keys=True,
                          separators=(",", ":"))
    except (TypeError, ValueError):
        return repr(query_json)


def entity_tag(entity_type: str, entity_id: Any) -> str:
    return f"{entity_type}:{entity_id}"


class ServingCache:
    """Tier container + bus subscription + ``pio_cache_*`` metrics."""

    def __init__(self, *,
                 query_entries: int = 8192,
                 query_ttl_sec: float = 30.0,
                 feature_entries: int = 8192,
                 feature_ttl_sec: float = 5.0,
                 hot_capacity: int = 512,
                 hot_refresh_every: int = 256,
                 pin_fn: Optional[PinFn] = None,
                 bus: Optional[InvalidationBus] = None) -> None:
        self.query = ShardedTTLCache(max_entries=query_entries,
                                     ttl_sec=query_ttl_sec)
        self.features = ShardedTTLCache(max_entries=feature_entries,
                                        ttl_sec=feature_ttl_sec)
        self.hot = (HotEntityTier(pin_fn, capacity=hot_capacity,
                                  refresh_every=hot_refresh_every)
                    if pin_fn is not None and hot_capacity > 0 else None)
        self.flight = SingleFlight()
        #: guards the flat counters below — bus deliveries arrive on
        #: whatever thread accepted the ingest, so even `x += 1` is a
        #: read-modify-write race without it
        self._counter_lock = new_lock("ServingCache._counter_lock")
        self._flushes = 0
        self._bus_events = 0
        # invalidation epochs: a query computed CONCURRENTLY with an
        # ingest must not be cached after the ingest's invalidation
        # already ran (it would then serve stale until the TTL). Every
        # invalidation bumps the entity tag's epoch (flushes bump the
        # global one) BEFORE removing entries; fill paths snapshot the
        # epoch pre-compute and drop their put if it moved (see
        # put_query_fresh).
        self._epoch_lock = new_lock("ServingCache._epoch_lock")
        self._global_epoch = 0
        self._tag_epochs: Dict[str, int] = {}
        self._stale_put_drops = 0
        self.bus = bus if bus is not None else default_bus()
        # weak subscription: dropping the owning QueryServer drops us
        self.bus.subscribe(self)

    # -- invalidation epochs -------------------------------------------------
    #: tag-epoch map cap — past it the map is cleared and the GLOBAL
    #: epoch bumped instead (every in-flight put aborts once; correct,
    #: just momentarily conservative)
    MAX_TAG_EPOCHS = 65536

    def epoch_token(self, tag: Optional[str]):
        """Snapshot taken BEFORE computing a cacheable result."""
        with self._epoch_lock:
            return (self._global_epoch,
                    self._tag_epochs.get(tag, 0) if tag else 0, tag)

    def _bump_tag(self, tag: str) -> None:
        with self._epoch_lock:
            if len(self._tag_epochs) >= self.MAX_TAG_EPOCHS:
                self._tag_epochs.clear()
                self._global_epoch += 1
            self._tag_epochs[tag] = self._tag_epochs.get(tag, 0) + 1

    def _bump_global(self) -> None:
        with self._epoch_lock:
            self._global_epoch += 1

    def _epoch_moved(self, token) -> bool:
        g, te, tag = token
        with self._epoch_lock:
            return (self._global_epoch != g
                    or (tag is not None
                        and self._tag_epochs.get(tag, 0) != te))

    def put_query_fresh(self, key, value, tags: Tuple[str, ...],
                        token) -> bool:
        """Cache a computed result UNLESS an invalidation covering it
        ran since ``token`` was taken. Order matters: put FIRST, then
        re-check — an invalidator that runs after the put finds the
        entry in the tag index and removes it itself; one that ran
        entirely before the put is caught by the re-check. Either way
        no stale entry survives to the TTL."""
        if self._epoch_moved(token):
            self._count_stale_put()
            return False
        self.query.put(key, value, tags=tags)
        if self._epoch_moved(token):
            self.query.invalidate_key(key)
            self._count_stale_put()
            return False
        return True

    def _count_stale_put(self) -> None:
        with self._counter_lock:
            self._stale_put_drops += 1

    # -- invalidation (the bus calls this on every ingest) ------------------
    def on_event(self, app_id: Optional[int], entity_type: str,
                 entity_id: str, event_name: str = "") -> None:
        with self._counter_lock:
            self._bus_events += 1
        tag = entity_tag(entity_type, entity_id)
        self._bump_tag(tag)  # BEFORE removal: in-flight fills must see
        self.query.invalidate_tag(tag)          # the moved epoch
        self.features.invalidate_tag(tag)
        if entity_type == "constraint":
            # catalog-wide constraints (unavailableItems, weightedItems)
            # re-shape EVERY result — per-tag surgery can't be precise
            self._bump_global()
            self.query.flush()

    def invalidate_entities(self, entity_type: str, entity_ids) -> None:
        """Per-entity invalidation OUTSIDE the ingest bus: the
        streaming trainer's delta apply calls this after
        hot-swapping folded factor rows — a result for a touched
        entity cached between its ingest (which the bus already
        invalidated) and the fold-in was computed by the pre-fold
        model and must not survive to the TTL. Same epoch discipline
        as :meth:`on_event`: bump BEFORE removal so in-flight fills
        drop themselves."""
        for eid in entity_ids:
            tag = entity_tag(entity_type, eid)
            self._bump_tag(tag)
            self.query.invalidate_tag(tag)
            self.features.invalidate_tag(tag)

    # -- flush (rebind / operator) ------------------------------------------
    def flush_namespace(self, namespace: str) -> int:
        """Wipe one release arm's query results (promote/rollback of
        the OTHER arm leaves this one untouched)."""
        self._bump_global()
        return self.query.flush(namespace)

    def flush_all(self) -> Dict[str, int]:
        """Full flush — every rebind (deploy/reload/promote/rollback)
        and the ``/cache/flush`` operator route take this path: a new
        model must never serve results computed by the old one."""
        with self._counter_lock:
            self._flushes += 1
        self._bump_global()
        out = {"query": self.query.flush(),
               "feature": self.features.flush()}
        if self.hot is not None:
            out["hot"] = self.hot.flush()
        return out

    def close(self) -> None:
        """Leave the bus and close the hot tier (its refresh thread is
        joined). Idempotent."""
        self.bus.unsubscribe(self)
        if self.hot is not None:
            self.hot.close()

    # -- observability ------------------------------------------------------
    def _tiers(self) -> Iterable[Tuple[str, Any]]:
        yield "query", self.query
        yield "feature", self.features
        if self.hot is not None:
            yield "hot", self.hot

    def stats(self) -> Dict[str, Any]:
        with self._counter_lock:
            flushes, bus_events = self._flushes, self._bus_events
            stale_puts = self._stale_put_drops
        out: Dict[str, Any] = {"enabled": True,
                               "flushes": flushes,
                               "busEvents": bus_events,
                               "singleflightCoalesced":
                                   self.flight.coalesced,
                               "stalePutDrops": stale_puts,
                               "tiers": {}}
        for name, tier in self._tiers():
            out["tiers"][name] = tier.stats()
        return out

    def register_metrics(self, registry) -> None:
        """Mount the ``pio_cache_*`` series on a server's
        :class:`~predictionio_tpu_torch.obs.MetricsRegistry`. Gauges backed
        by live tier counters — one source of truth, no dual
        bookkeeping (the counters only go up, so ``rate()`` works)."""
        fams = {
            "hits": registry.gauge(
                "pio_cache_hits",
                "Serving-cache hits per tier (monotonic)"),
            "misses": registry.gauge(
                "pio_cache_misses",
                "Serving-cache misses per tier (monotonic)"),
            "evictions": registry.gauge(
                "pio_cache_evictions",
                "Entries evicted by LRU capacity per tier (monotonic)"),
            "invalidations": registry.gauge(
                "pio_cache_invalidations",
                "Entries removed by bus/TTL-flush invalidation per "
                "tier (monotonic)"),
            "entries": registry.gauge(
                "pio_cache_entries", "Live cached entries per tier"),
            "bytes": registry.gauge(
                "pio_cache_bytes",
                "Approximate bytes held per tier"),
            "hitRatio": registry.gauge(
                "pio_cache_hit_ratio",
                "Lifetime hit ratio per tier"),
        }
        for name, tier in self._tiers():
            for stat, fam in fams.items():
                fam.labels(tier=name).set_fn(
                    lambda t=tier, s=stat: t.stats()[s])
        registry.gauge(
            "pio_cache_singleflight_coalesced",
            "Concurrent identical misses deduplicated onto one "
            "computation (monotonic)",
            fn=lambda: self.flight.coalesced)
        registry.gauge(
            "pio_cache_flushes",
            "Full cache flushes (rebind or operator, monotonic)",
            # a scrape-time read of a monotonic int: a torn read is
            # impossible in CPython and an off-by-one scrape is harmless
            fn=lambda: self._flushes)
