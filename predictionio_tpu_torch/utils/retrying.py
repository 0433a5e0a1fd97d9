"""Bounded-exponential-backoff retry: the port's own copy of
``predictionio_tpu/utils/retrying.py``, shared by the stream trainer's
storage calls and any other code that talks to something that fails
for a while.

Every loop here is *bounded* (max attempts) and *paced* (exponential
backoff with a cap and optional jitter). Transient faults degrade into a
short stall; persistent ones surface the LAST error after a known,
finite budget instead of wedging a daemon.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Tuple, Type

__all__ = ["RetryPolicy", "backoff_delays", "retry_call"]


@dataclass(frozen=True)
class RetryPolicy:
    """``attempt k`` (0-based) waits ``min(cap_ms, base_ms * 2**k)``
    ± ``jitter`` fraction before retrying."""

    max_attempts: int = 4      # total tries, including the first
    base_ms: float = 50.0
    cap_ms: float = 2000.0
    jitter: float = 0.1        # fraction of the delay, uniform ±

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")


def backoff_delays(policy: RetryPolicy) -> Iterator[float]:
    """The seconds to sleep before retry k (yields
    ``max_attempts - 1`` values — no sleep after the last failure)."""
    for k in range(policy.max_attempts - 1):
        delay = min(policy.cap_ms, policy.base_ms * (2 ** k)) / 1000.0
        if policy.jitter:
            delay *= 1.0 + random.uniform(-policy.jitter, policy.jitter)
        yield max(delay, 0.0)


def retry_call(fn: Callable, *args,
               policy: RetryPolicy = RetryPolicy(),
               retry_on: Tuple[Type[BaseException], ...] = (Exception,),
               **kwargs):
    """Call ``fn(*args, **kwargs)``; on a ``retry_on`` exception, back
    off per ``policy`` and retry, re-raising the last error once the
    attempt budget is spent."""
    delays = backoff_delays(policy)
    for _ in range(policy.max_attempts):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            try:
                delay = next(delays)
            except StopIteration:
                raise e
            time.sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover
