"""Deadlock watchdog (the port's own copy of
``predictionio_tpu/concurrency/watchdog.py``): dump every thread's stack
to the access log.

When an instrumented lock wait exceeds the watchdog threshold
(:func:`~.locks.watchdog_threshold_sec`), :class:`~.locks.DebugLock`
calls :func:`dump_all_stacks`. The dump goes to the
``predictionio_tpu_torch.access`` logger — the structured serving timeline —
so the post-mortem sits next to the requests that hung, and a log
shipper already collecting access lines gets the stacks for free.
"""

from __future__ import annotations

import logging
import sys
import threading
import traceback
from typing import Optional

__all__ = ["dump_all_stacks"]

#: the engine/event servers' structured access log (server/http.py)
access_log = logging.getLogger("predictionio_tpu_torch.access")


def format_all_stacks(reason: str = "") -> str:
    """Every live thread's stack as one block, deadlock-report style:
    thread name/ident/daemon flag, then the frames, innermost last."""
    by_ident = {t.ident: t for t in threading.enumerate()}
    parts = []
    if reason:
        parts.append(f"=== lock watchdog: {reason} ===")
    for ident, frame in sorted(sys._current_frames().items()):
        thread = by_ident.get(ident)
        name = thread.name if thread is not None else "?"
        daemon = thread.daemon if thread is not None else "?"
        parts.append(f"--- thread {name!r} (ident={ident}, "
                     f"daemon={daemon}) ---")
        parts.append("".join(traceback.format_stack(frame)).rstrip())
    return "\n".join(parts)


def dump_all_stacks(reason: str = "",
                    logger: Optional[logging.Logger] = None) -> str:
    """Format and log all thread stacks; returns the formatted block
    (tests assert on it). Never raises — a watchdog that crashes the
    waiter it is diagnosing would be worse than no watchdog."""
    try:
        block = format_all_stacks(reason)
        (logger or access_log).error("%s", block)
        return block
    except Exception as e:  # noqa: BLE001 — diagnostics must not kill
        logging.getLogger(__name__).error(
            "watchdog stack dump failed: %s", e)
        return ""
