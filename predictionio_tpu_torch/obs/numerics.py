"""Opt-in runtime NaN/Inf sentinels for the numeric serving stack (the
port's copy of ``predictionio_tpu/obs/numerics.py``).

The values are watched at the two seams where a nonfinite can enter
production silently: the streaming fold-in solve (a NaN row hot-swapped
into the serving table poisons every score it touches) and the served
top-k scores.

- **Zero overhead off.** Every instrumented site goes through one
  module-global bool check. Enabled by ``ServerConfig.debug_numerics`` or
  ``PTPU_DEBUG_NUMERICS=1``.
- **On the card where it matters.** :func:`checked_call` runs an entry
  and sweeps its floating outputs with ``torch.isfinite`` on their own
  device, so a NaN is attributed to the entry that produced it (the JAX
  package's ``checkify`` flags the op inside the entry; the sweep flags
  the entry's outputs).
- **On the host at the seams.** :func:`check_array` is a numpy
  ``isfinite`` sweep of a host array (the served scores' host copy).
- **Listener fan-out.** The engine server subscribes a listener that
  bumps ``pio_numerics_checks_total`` / ``pio_numerics_nonfinite_total
  {entry=...}`` and flags ``nonfinite`` in ``/status.json``'s
  ``degraded`` block.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List

#: the ONE fast-path gate: False => instrumented sites return before
#: touching anything else
_ACTIVE = False

_lock = threading.Lock()
_stats: Dict[str, List[int]] = {}   # entry -> [checks, nonfinite]
_listeners: List[Callable[[str, bool], None]] = []


def debug_env() -> bool:
    """``PTPU_DEBUG_NUMERICS=1``: the enable that needs no config
    change."""
    return os.environ.get("PTPU_DEBUG_NUMERICS", "").strip().lower() \
        in ("1", "true", "yes", "on")


def enable() -> None:
    global _ACTIVE
    _ACTIVE = True


def disable() -> None:
    global _ACTIVE
    _ACTIVE = False


def active() -> bool:
    return _ACTIVE


def add_listener(cb: Callable[[str, bool], None]) -> None:
    """``cb(entry, nonfinite)`` after every delivered check."""
    with _lock:
        _listeners.append(cb)


def remove_listener(cb: Callable[[str, bool], None]) -> None:
    with _lock:
        try:
            _listeners.remove(cb)
        except ValueError:
            pass


def _record(entry: str, bad: bool) -> None:
    with _lock:
        st = _stats.setdefault(entry, [0, 0])
        st[0] += 1
        if bad:
            st[1] += 1
        listeners = list(_listeners)
    for cb in listeners:
        try:
            cb(entry, bad)
        except Exception:  # noqa: BLE001 — telemetry only
            pass


def check_array(entry: str, arr, *, nan_only: bool = False) -> bool:
    """Host finiteness probe; True when clean (or inactive).
    ``nan_only`` is for seams where +-inf is a legitimate mask sentinel
    (top-k scores pad with -inf)."""
    if not _ACTIVE:
        return True
    import numpy as np

    a = np.asarray(arr)
    if a.dtype.kind != "f":
        bad = False
    elif nan_only:
        bad = bool(np.isnan(a).any())
    else:
        bad = bool(not np.isfinite(a).all())
    _record(entry, bad)
    return not bad


def checked_call(entry: str, fn: Callable, *args, **kwargs):
    """Run ``fn`` and, when active, sweep its floating tensor outputs
    (the result, or a tuple's or list's tensors) with ``torch.isfinite``
    on their own device: one reduction each and one readback of the
    verdict, the debug mode's documented cost. A pass-through when
    off."""
    out = fn(*args, **kwargs)
    if not _ACTIVE:
        return out
    import torch

    items = out if isinstance(out, (tuple, list)) else (out,)
    bad = any(not bool(torch.isfinite(t).all()) for t in items
              if isinstance(t, torch.Tensor) and t.is_floating_point())
    _record(entry, bad)
    return out


def nonfinite_seen() -> bool:
    """Any check observed NaN/Inf since the last reset: the ``nonfinite``
    flag of ``/status.json``'s degraded block."""
    with _lock:
        return any(st[1] for st in _stats.values())


def stats() -> Dict[str, Dict[str, int]]:
    with _lock:
        return {entry: {"checks": st[0], "nonfinite": st[1]}
                for entry, st in sorted(_stats.items())}


def reset_for_tests() -> None:
    global _ACTIVE
    with _lock:
        _stats.clear()
        _listeners.clear()
    _ACTIVE = False


__all__ = [
    "active",
    "add_listener",
    "check_array",
    "checked_call",
    "debug_env",
    "disable",
    "enable",
    "nonfinite_seen",
    "remove_listener",
    "reset_for_tests",
    "stats",
]
