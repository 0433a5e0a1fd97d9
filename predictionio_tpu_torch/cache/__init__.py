"""Serving-path cache hierarchy (the port of ``predictionio_tpu/cache/``).

Three tiers between the HTTP parse and the card: an exact-key
query-result cache (sharded LRU + TTL, with singleflight), a feature
cache for serving-time event-store reads, and the hot-entity tier that
ranks the hottest users from a small pinned table on the card, kept
honest by the invalidation bus the event server publishes to on every
ingest.

Pure host-side code: importing this package imports no torch (the event
server and the storage-only commands import it).
"""

from .bus import InvalidationBus, default_bus
from .hierarchy import ServingCache, canonical_key, entity_tag
from .hot import HotEntityTier
from .lru import ShardedTTLCache, approx_bytes
from .singleflight import SingleFlight

__all__ = [
    "HotEntityTier",
    "InvalidationBus",
    "ServingCache",
    "ShardedTTLCache",
    "SingleFlight",
    "approx_bytes",
    "canonical_key",
    "default_bus",
    "entity_tag",
]
