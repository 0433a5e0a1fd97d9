"""Launch counters of the kernel wrappers.

Each wrapper module (``fused_topk``, ``fused_gram``, ``solve``, ``gram``)
keeps ``LAUNCHES``: the calls that launched its kernel since the last
reset, one a call. ``chip_smoke.py`` resets a count by assigning 0 and
reads it after driving a path; ``/status.json`` reports ``fused_topk``'s.
Wrappers run on many threads at once (the staged pipeline's dispatch
threads, a parallel eval grid walk), and ``LAUNCHES += 1`` is a load, an
add and a store that a thread switch can split, losing a count. So every
wrapper counts through :func:`count_launch`, under one lock.
"""

from __future__ import annotations

import sys
import threading

_lock = threading.Lock()


def count_launch(module_name: str, **also) -> None:
    """Add one to ``LAUNCHES`` of the wrapper module ``module_name`` and
    set its other module attributes in ``also`` (``gram``'s
    ``LAST_PATH``) under the same lock."""
    mod = sys.modules[module_name]
    with _lock:
        mod.LAUNCHES += 1
        for name, value in also.items():
            setattr(mod, name, value)
