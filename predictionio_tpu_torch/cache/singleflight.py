"""Singleflight: concurrent identical cache misses compute ONCE (the
port's own copy of ``predictionio_tpu/cache/singleflight.py``).

Unlike :class:`~predictionio_tpu_torch.utils.memo.ComputeOnce` (a permanent
memo), a singleflight entry lives only while the computation is in
flight: the first caller for a key becomes the **leader** and runs the
thunk; callers that arrive before it finishes block on the same Future
and share the result (or the exception); the entry is then removed, so
the next miss after the cache expires/invalidates computes fresh.

This is what keeps a hot-key TTL expiry from turning into a thundering
herd of identical device dispatches: N concurrent misses for one query
cost one supplement + one dispatch, not N.
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import Any, Callable, Dict, Hashable, Tuple

from ..concurrency import new_lock

__all__ = ["SingleFlight"]


class SingleFlight:
    def __init__(self) -> None:
        self._lock = new_lock("SingleFlight._lock")
        self._flights: Dict[Hashable, Future] = {}
        self._coalesced = 0  # followers served by a leader's flight

    def do(self, key: Hashable, fn: Callable[[], Any]
           ) -> Tuple[Any, bool]:
        """Returns ``(value, leader)`` — ``leader`` is True for the
        caller that actually ran ``fn``. Exceptions propagate to the
        leader AND every follower of that flight."""
        with self._lock:
            fut = self._flights.get(key)
            leader = fut is None
            if leader:
                fut = self._flights[key] = Future()
            else:
                self._coalesced += 1
        if leader:
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 — to all waiters
                fut.set_exception(e)
            finally:
                with self._lock:
                    self._flights.pop(key, None)
        return fut.result(), leader

    @property
    def coalesced(self) -> int:
        """How many callers were deduplicated onto another's flight."""
        with self._lock:
            return self._coalesced

    def in_flight(self) -> int:
        with self._lock:
            return len(self._flights)
