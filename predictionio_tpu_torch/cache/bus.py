"""Invalidation bus: the event server tells subscribers what just
changed (the port's own copy of ``predictionio_tpu/cache/bus.py``).

On every accepted ingest the event server publishes
``(app_id, entity_type, entity_id, event_name)``. The subscribers are
the serving caches (:class:`~.hierarchy.ServingCache`), which drop the
entries whose tags cover that entity, and the stream trainer, which an
ingest for its app wakes at once instead of at its next poll.

Delivery is **synchronous and in-process**: by the time the ingest HTTP
response is written, every subscriber has been called, so no later query
serves the pre-ingest cached result. An event server in another process
reaches a cache through its TTL bound, and the trainer through its poll.

Subscribers are held by **weakref**: a test that drops its subscriber
must not leave it wired into the process-global bus forever.
"""

from __future__ import annotations

import logging
import threading
import weakref
from typing import Any, Callable, List, Optional

from ..concurrency import new_lock

log = logging.getLogger(__name__)

__all__ = ["InvalidationBus", "default_bus"]

#: subscriber signature: (app_id, entity_type, entity_id, event_name)
Subscriber = Callable[[Optional[int], str, str, str], Any]


class InvalidationBus:
    def __init__(self) -> None:
        self._lock = new_lock("InvalidationBus._lock")
        self._subs: List[weakref.ref] = []
        self._published = 0
        self._delivered = 0

    def subscribe(self, owner: Any, method_name: str = "on_event") -> None:
        """Subscribe ``owner.<method_name>``; ``owner`` is held weakly
        (bound methods would keep the owner alive through the bus —
        ``WeakMethod`` keeps the reference honest)."""
        ref = weakref.WeakMethod(getattr(owner, method_name))
        with self._lock:
            self._subs.append(ref)

    def unsubscribe(self, owner: Any,
                    method_name: str = "on_event") -> None:
        target = getattr(owner, method_name, None)
        with self._lock:
            self._subs = [r for r in self._subs
                          if r() is not None and r() != target]

    def publish(self, app_id: Optional[int], entity_type: str,
                entity_id: str, event_name: str = "") -> int:
        """Deliver to every live subscriber; returns how many were
        reached. A failing subscriber is logged and skipped — ingest
        must never fail because a cache hiccuped."""
        with self._lock:
            refs = list(self._subs)
        delivered = 0
        dead = False
        for ref in refs:
            fn = ref()
            if fn is None:
                dead = True
                continue
            try:
                fn(app_id, entity_type, entity_id, event_name)
                delivered += 1
            except Exception as e:  # noqa: BLE001 — ingest goes on
                log.error("cache invalidation subscriber failed: %s", e)
        if dead:
            with self._lock:
                self._subs = [r for r in self._subs if r() is not None]
        with self._lock:
            self._published += 1
            self._delivered += delivered
        return delivered

    def publish_many(self, app_id: Optional[int],
                     items: List[tuple]) -> int:
        """Coalesced multi-entity publish: deliver every
        ``(entity_type, entity_id, event_name)`` of one accepted batch
        with ONE subscriber snapshot and one stats update, instead of
        a full :meth:`publish` (two lock passes + dead-ref sweep) per
        item — the event server's batch/webhook ingest path. Per-item
        delivery to each subscriber is preserved, so tag semantics are
        exactly those of N single publishes."""
        if not items:
            return 0
        with self._lock:
            refs = list(self._subs)
        delivered = 0
        dead = False
        for ref in refs:
            fn = ref()
            if fn is None:
                dead = True
                continue
            for entity_type, entity_id, event_name in items:
                try:
                    fn(app_id, entity_type, entity_id, event_name)
                    delivered += 1
                except Exception as e:  # noqa: BLE001 — ingest goes on
                    log.error("cache invalidation subscriber failed: %s",
                              e)
        if dead:
            with self._lock:
                self._subs = [r for r in self._subs if r() is not None]
        with self._lock:
            self._published += len(items)
            self._delivered += delivered
        return delivered

    def subscriber_count(self) -> int:
        """Subscribers still alive (the dead are dropped lazily)."""
        with self._lock:
            return sum(1 for r in self._subs if r() is not None)

    def stats(self) -> dict:
        with self._lock:
            return {"subscribers": sum(1 for r in self._subs
                                       if r() is not None),
                    "published": self._published,
                    "delivered": self._delivered}


_default: Optional[InvalidationBus] = None
_default_lock = threading.Lock()


def default_bus() -> InvalidationBus:
    """The process-wide bus: event-server ingest publishes here and
    every serving cache subscribes here unless given its own."""
    global _default
    with _default_lock:
        if _default is None:
            _default = InvalidationBus()
        return _default
