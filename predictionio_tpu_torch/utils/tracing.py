"""Wall-clock spans (the port's copy of ``predictionio_tpu/utils/tracing.py``).

``timed(name)`` records how long a block took (``time.perf_counter``) into
a :class:`SpanRegistry` (the process-wide :data:`spans` unless another is
given). The servers expose the registry as ``pio_span_seconds``
(:func:`predictionio_tpu_torch.obs.mount_span_metrics`).

While a ``torch.profiler`` capture runs (``POST /profile``, :func:`trace`,
or any caller's own profiler) a span does more: it opens a
``record_function`` range ``ptpu.<name>``, so it lies on the device
trace's clock beside the kernels it launched, and the registry keeps it,
``(name, start, end, parent, id)``, in a bounded ring with the span that
was open around it on the same thread as its parent. ``spans.count(name,
n)`` keeps counts beside the spans, under capture too. With no capture a
span costs two clock reads and one histogram record, and a count nothing.

``trace(log_dir)`` is the counterpart of the JAX package's
``jax.profiler`` capture: a ``torch.profiler`` capture of the block (the
card's kernels too where CUDA is up), written under ``log_dir`` as a
Chrome trace (``ui.perfetto.dev``, ``chrome://tracing``). The server's
bounded capture is :class:`predictionio_tpu_torch.obs.trace.DeviceProfiler`;
both hold the process's one profiler.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, NamedTuple, Optional

from ..obs.histogram import StreamingHistogram

log = logging.getLogger(__name__)

#: the profiler's "a capture is running" check, bound at first use so that
#: importing this module loads no torch
_profiler_enabled = None


def capturing() -> bool:
    """Whether a ``torch.profiler`` capture runs in this process."""
    global _profiler_enabled
    if _profiler_enabled is None:
        import torch

        _profiler_enabled = torch.autograd._profiler_enabled
    return _profiler_enabled()


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture the block with ``torch.profiler`` into
    ``log_dir/trace-<pid>-<ns>.json`` (a Chrome trace); nothing when
    ``log_dir`` is falsy. Raises ``RuntimeError`` while another capture
    of this process runs."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..obs.trace import profiler_held

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace-{os.getpid()}-{time.time_ns()}.json")
    with profiler_held():
        prof = profile(activities=activities)
        prof.start()
        try:
            yield
        finally:
            prof.stop()
            prof.export_chrome_trace(path)
            log.info("torch.profiler trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Label a host-side phase on the profiler timeline, while a
    ``torch.profiler`` capture is running (nothing otherwise)."""
    if not capturing():
        yield
        return
    import torch

    with torch.profiler.record_function(name):
        yield


class SpanRecord(NamedTuple):
    """One span kept under capture: ``time.perf_counter`` seconds at its
    ends, and ``parent`` the ``id`` of the span open around it on its
    thread (-1 at the top)."""

    name: str
    start: float
    end: float
    parent: int
    id: int


class CountRecord(NamedTuple):
    """One ``count(name, n)`` kept under capture, at ``at`` seconds
    (``time.perf_counter``), inside the span ``parent``."""

    name: str
    at: float
    n: int
    parent: int


class SpanRegistry:
    """Thread-safe wall-clock span collection, bounded per name: each name
    is one fixed-bucket :class:`StreamingHistogram`, so ``record`` is O(1)
    and memory is constant however many observations arrive. Under a
    profiler capture it also keeps each span and count in a ring of
    :data:`RING` entries, which drops its oldest past that and counts
    the drops (:attr:`dropped`)."""

    #: a caller minting span names per request must not grow the registry
    #: without bound; past this, records fold into one overflow name
    MAX_SPAN_NAMES = 1024
    _OVERFLOW = "(overflow)"
    #: spans (and, apart, counts) kept under capture
    RING = 65_536

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._spans: Dict[str, StreamingHistogram] = {}
        self._ring: deque = deque(maxlen=self.RING)
        self._counts: deque = deque(maxlen=self.RING)
        #: ring entries dropped for room, spans and counts together
        self.dropped = 0
        self._open = threading.local()
        self._ids = itertools.count()

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            hist = self._spans.get(name)
            if hist is None:
                if len(self._spans) >= self.MAX_SPAN_NAMES:
                    name = self._OVERFLOW
                    hist = self._spans.get(name)
                if hist is None:
                    hist = self._spans[name] = StreamingHistogram()
        hist.record(seconds)

    def _stack(self) -> List[int]:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    def _push(self) -> tuple:
        """Open a kept span on this thread: ``(its id, its parent)``."""
        stack = self._stack()
        span_id = next(self._ids)
        parent = stack[-1] if stack else -1
        stack.append(span_id)
        return span_id, parent

    def _keep(self, ring: deque, entry: tuple) -> None:
        with self._lock:
            if len(ring) == ring.maxlen:
                self.dropped += 1
            ring.append(entry)

    def _pop(self, rec: SpanRecord) -> None:
        stack = self._stack()
        if rec.id in stack:
            stack.remove(rec.id)
        self._keep(self._ring, rec)

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to the counter ``name``, while a capture runs."""
        if not capturing():
            return
        stack = self._stack()
        self._keep(self._counts, CountRecord(
            name, time.perf_counter(), n, stack[-1] if stack else -1))

    def kept(self, start: float = float("-inf"),
             end: float = float("inf")) -> List[SpanRecord]:
        """The kept spans that lie wholly inside ``[start, end]``
        (``time.perf_counter`` seconds), oldest first."""
        with self._lock:
            return [r for r in self._ring
                    if r.start >= start and r.end <= end]

    def counted(self, start: float = float("-inf"),
                end: float = float("inf")) -> Dict[str, int]:
        """Each counter's total over the counts kept inside ``[start,
        end]``."""
        out: Dict[str, int] = {}
        with self._lock:
            for r in self._counts:
                if start <= r.at <= end:
                    out[r.name] = out.get(r.name, 0) + r.n
        return out

    def histograms(self) -> Dict[str, StreamingHistogram]:
        """The live per-name histograms (the ``/metrics`` bridge)."""
        with self._lock:
            return dict(self._spans)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for name, h in self.histograms().items():
            if not h.count:
                continue
            s = h.snapshot()
            out[name] = {
                "count": s["count"],
                "total_sec": s["sum"],
                "mean_sec": s["mean"],
                "max_sec": s["max"],
                "p50": s["p50"],
                "p90": s["p90"],
                "p99": s["p99"],
            }
        return out

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._ring.clear()
            self._counts.clear()
            self.dropped = 0


#: the process-wide registry; every server's ``/metrics`` mounts it
spans = SpanRegistry()


class timed:
    """Time a block into the span registry (``with timed(name):``); under
    a profiler capture also a ``ptpu.<name>`` range on the timeline and a
    kept :class:`SpanRecord`. ``seconds`` holds the block's duration once
    it ends."""

    __slots__ = ("name", "registry", "seconds", "_t0", "_range", "_id",
                 "_parent")

    def __init__(self, name: str,
                 registry: Optional[SpanRegistry] = None) -> None:
        self.name = name
        self.registry = spans if registry is None else registry
        self.seconds = 0.0
        self._range = None

    def __enter__(self) -> "timed":
        if capturing():
            import torch

            self._range = torch.profiler.record_function("ptpu." + self.name)
            self._range.__enter__()
            self._id, self._parent = self.registry._push()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        self.seconds = t1 - self._t0
        self.registry.record(self.name, self.seconds)
        if self._range is not None:
            rng, self._range = self._range, None
            self.registry._pop(SpanRecord(self.name, self._t0, t1,
                                          self._parent, self._id))
            rng.__exit__(*exc)
