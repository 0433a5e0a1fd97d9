"""Host spans the benchmark records around its calls into the program.

Each span is a host-clock interval with a name; it is also a
``torch.profiler.record_function`` range named ``pb.<name>``, so a traced
run's device trace shows what the host was doing in each idle gap.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple


class Spans:
    """Named host intervals (``time.perf_counter`` seconds)."""

    def __init__(self):
        self.by_name: Dict[str, List[Tuple[float, float]]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        from torch.profiler import record_function

        with record_function("pb." + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.by_name[name].append((t0, time.perf_counter()))

    def add(self, name: str, t0: float, t1: float) -> None:
        self.by_name[name].append((t0, t1))

    def durations(self, name: str, within: Tuple[float, float],
                  outside: Tuple[float, float] = None) -> List[float]:
        """Seconds of each ``name`` span inside the interval ``within``
        (the measured window), leaving out those that overlap the
        interval ``outside`` (a traced sub-window, where the profiler
        slows the host)."""
        out = []
        for t0, t1 in self.by_name.get(name, ()):
            if t0 < within[0] or t1 > within[1]:
                continue
            if outside is not None and t1 > outside[0] and t0 < outside[1]:
                continue
            out.append(t1 - t0)
        return out
