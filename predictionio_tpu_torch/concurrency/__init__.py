"""Concurrency correctness checked live (the port of
``predictionio_tpu/concurrency/``).

- :func:`new_lock` / :func:`new_rlock`: the serving stack's lock
  constructors. The stdlib locks themselves when instrumentation is off;
  :class:`DebugLock` when on.
- :class:`DebugLock` / :class:`LockRegistry`: the acquisition-order
  graph, lock-order-inversion and same-thread re-entry detection, wait,
  hold and contention telemetry.
- :func:`register_lock_metrics`: the ``pio_lock_*`` families.
- :func:`dump_all_stacks`: the deadlock watchdog's all-thread stack dump
  into the access log.

Switched on by ``ServerConfig(debug_locks=True)``, ``deploy
--debug-locks`` or ``PTPU_DEBUG_LOCKS=1``.
"""

from .locks import (
    DebugLock,
    LockRegistry,
    instrument_locks,
    lock_registry,
    locks_instrumented,
    new_lock,
    new_rlock,
    register_lock_metrics,
    watchdog_threshold_sec,
)
from .watchdog import dump_all_stacks, format_all_stacks

__all__ = [
    "DebugLock",
    "LockRegistry",
    "dump_all_stacks",
    "format_all_stacks",
    "instrument_locks",
    "lock_registry",
    "locks_instrumented",
    "new_lock",
    "new_rlock",
    "register_lock_metrics",
    "watchdog_threshold_sec",
]
