"""Serving-side change notification: the port has the invalidation bus
only (:mod:`.bus`); the query caches wait (``ROADMAP.md`` queue 1
item 8)."""
