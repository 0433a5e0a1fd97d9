"""Thread-safe compute-once memoization: the port's own copy of
``predictionio_tpu/utils/memo.py``.

The first caller of a key runs the thunk; concurrent callers for the
same key block on its Future. The parallel eval grid walk's prefix
caches (``controller/evaluation.py``) and the ALS pack cache
(``models/als.py``) use it, so a grid walked on several threads still
reads each fold, packs each fold's ratings and trains each (fold,
algorithm params) prefix once.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, Hashable, Tuple


class ComputeOnce:
    """Per-key first-caller-computes cache.

    ``retry_on_failure=True`` drops a failed key so a later caller can
    retry (a transient failure, such as running out of device memory
    while packing, should not poison the cache); waiters of the failing
    attempt still see the exception.
    """

    def __init__(self, retry_on_failure: bool = False):
        self._lock = threading.Lock()
        self._futs: Dict[Hashable, Future] = {}
        self._retry = retry_on_failure

    def get(self, key: Hashable, fn: Callable[[], Any]) -> Any:
        return self.get_timed(key, fn)[0]

    def get_timed(self, key: Hashable, fn: Callable[[], Any]
                  ) -> Tuple[Any, float]:
        """Returns ``(value, seconds_this_caller_spent_computing)``: 0.0
        for cache hits and for waiters blocked on another thread's
        computation (their blocked time is not their compute time)."""
        with self._lock:
            fut = self._futs.get(key)
            owner = fut is None
            if owner:
                fut = self._futs[key] = Future()
        spent = 0.0
        if owner:
            t0 = time.monotonic()
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 - handed to waiters
                if self._retry:
                    with self._lock:
                        self._futs.pop(key, None)
                fut.set_exception(e)
            spent = time.monotonic() - t0
        return fut.result(), spent
