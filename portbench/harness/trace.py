"""The traced run's profiler window and its reduction to device busy
time, time by kernel, and idle gaps by what the host was doing.

A ``--trace 1`` run profiles a sub-window of its measured window (a
whole window of training holds hundreds of thousands of kernels, more
than a trace can be read back from in the run's time): it starts at a
unit boundary a quarter of the way in and stops at the first boundary
``TRACE_SECONDS`` later. Before each switch the loop drains its work and
the card is synchronized, so the trace holds whole units, and the units
counted while it is on are the work its time is divided by.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

#: length of the traced sub-window, seconds (at most half the window)
TRACE_SECONDS = 3.0
#: where in the window the trace starts, as a share of the window
START_SHARE = 0.25
#: chrome-trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: entries of each breakdown list
TOP = 10


def short_name(name: str) -> str:
    """A device operation's name without its return type, anonymous
    namespaces and arguments."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:120]


@dataclass
class TraceSummary:
    """What a traced sub-window holds."""

    #: length of the traced window and the time in it with a device
    #: operation running (the union of their intervals), seconds
    window_s: float
    busy_s: float
    #: seconds of device operations by full name (summed, not a union)
    op_seconds: Dict[str, float]
    #: host clock (``time.perf_counter``) at the traced window's ends
    host: Tuple[float, float]
    breakdown: dict = field(default_factory=dict)

    def seconds_of(self, substrings) -> float:
        """Device seconds of every operation whose name holds one of
        ``substrings``."""
        return sum(s for n, s in self.op_seconds.items()
                   if any(k in n for k in substrings))

    @property
    def device_s(self) -> float:
        return sum(self.op_seconds.values())


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_trace(events: List[dict], host: Tuple[float, float]
                 ) -> Optional[TraceSummary]:
    """A :class:`TraceSummary` of chrome-trace ``events`` whose window is
    the ``pb.window`` range; None where the trace has no such range."""
    win = [e for e in events if e.get("name") == "pb.window"
           and e.get("cat") == "user_annotation" and "dur" in e]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = []
    op_us: Dict[str, float] = defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b <= a:
            continue
        dev.append((a, b))
        op_us[e["name"]] += b - a
    busy = _union(dev)
    busy_us = sum(b - a for a, b in busy)
    # idle gaps, each labelled by the benchmark's span and the host
    # operation running at its middle
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") == "user_annotation" and "dur" in e
                   and e["name"].startswith("pb.") and e["name"] != "pb.window")
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e["name"]) for e in events
                 if e.get("cat") == "cpu_op" and "dur" in e)
    span_starts = [s[0] for s in spans]
    op_starts = [o[0] for o in ops]

    def inner(items, starts, t) -> str:
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 64, -1), -1):
            if items[j][1] >= t:
                return items[j][2]
        return ""

    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        label = (f"{inner(spans, span_starts, mid) or '-'} / "
                 f"{inner(ops, op_starts, mid) or '(python)'}")
        gaps[label] += (b - a) * 1e-6
    by_short: Dict[str, float] = defaultdict(float)
    for n, us in op_us.items():
        by_short[short_name(n)] += us * 1e-6
    breakdown = {
        "device_ops": [[n, s] for n, s in sorted(
            by_short.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[n, s] for n, s in sorted(
            gaps.items(), key=lambda kv: -kv[1])[:TOP]],
    }
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                        op_seconds={n: us * 1e-6 for n, us in op_us.items()},
                        host=host, breakdown=breakdown)


class Tracer:
    """Switches ``torch.profiler`` on and off at a loop's unit
    boundaries (module docstring); a no-op unless ``enabled``."""

    def __init__(self, enabled: bool, seconds: float, cuda: bool):
        self.enabled = enabled
        self.cuda = cuda
        self.start_at = START_SHARE * seconds
        self.length = min(TRACE_SECONDS, 0.5 * seconds)
        self.active = False
        self.done = False
        #: work the loop counted while the trace was on
        self.work: Dict[str, float] = defaultdict(float)
        self.host: Tuple[float, float] = (0.0, 0.0)
        self._prof = None
        self._range = None
        self._t0 = 0.0
        #: seconds the profiler took to start inside the window
        self.start_s = 0.0

    def _activities(self) -> list:
        from torch.profiler import ProfilerActivity

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        return acts

    def prime(self) -> float:
        """Start and stop the profiler once, in set-up: its first start in
        a process initializes the device tracer, which has taken from
        under a second to ten seconds, and inside the window that would
        leave the trace a few flushes or none. Returns the seconds it
        took (0 unless ``enabled``)."""
        if not self.enabled:
            return 0.0
        from torch.profiler import profile

        t0 = time.perf_counter()
        with profile(activities=self._activities()):
            if self.cuda:
                import torch

                torch.ones(1, device="cuda").add_(1)
            self._sync()
        return time.perf_counter() - t0

    def _sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def boundary(self, elapsed: float, drain: Callable[[], None]) -> None:
        """Called by the loop between units, ``elapsed`` seconds into the
        window; ``drain`` finishes the work in flight."""
        if not self.enabled or self.done:
            return
        if not self.active and elapsed >= self.start_at:
            from torch.profiler import profile, record_function

            drain()
            self._sync()
            started = time.perf_counter()
            self._prof = profile(activities=self._activities())
            self._prof.start()
            self.start_s = time.perf_counter() - started
            self._range = record_function("pb.window")
            self._range.__enter__()
            # the length counts from here: starting the profiler can take
            # seconds
            self._t0 = time.perf_counter()
            self.active = True
        elif self.active and time.perf_counter() - self._t0 >= self.length:
            self.stop(drain)

    def stop(self, drain: Callable[[], None]) -> None:
        """End the trace (the loop calls it when its window ends)."""
        if not self.active:
            return
        drain()
        self._sync()
        self.host = (self._t0, time.perf_counter())
        self._range.__exit__(None, None, None)
        self._prof.stop()
        self.active = False
        self.done = True

    def add(self, key: str, n: float = 1.0) -> None:
        """Count ``n`` of ``key`` if the trace is on."""
        if self.active:
            self.work[key] += n

    def summary(self) -> Optional[TraceSummary]:
        """The traced window's reduction (None when nothing was traced).
        The trace goes through a file in the temporary directory, deleted
        once read."""
        if self._prof is None:
            return None
        fd, path = tempfile.mkstemp(prefix="portbench-trace-",
                                    suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self._prof = None
        return reduce_trace(events, self.host)
