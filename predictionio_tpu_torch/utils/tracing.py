"""Wall-clock spans (the port's copy of ``predictionio_tpu/utils/tracing.py``).

``timed(name)`` records how long a block took into a :class:`SpanRegistry`
(the process-wide :data:`spans` unless another is given) and labels it on
the ``torch.profiler`` timeline while a capture runs (``annotate``). The
servers expose the registry as ``pio_span_seconds``
(:func:`predictionio_tpu_torch.obs.mount_span_metrics`).

``trace(log_dir)`` is the counterpart of the JAX package's
``jax.profiler`` capture: a ``torch.profiler`` capture of the block (the
card's kernels too where CUDA is up), written under ``log_dir`` as a
Chrome trace (``ui.perfetto.dev``, ``chrome://tracing``). The server's
bounded capture is :class:`predictionio_tpu_torch.obs.trace.DeviceProfiler`;
both hold the process's one profiler.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Dict, Iterator, Optional

from ..obs.histogram import StreamingHistogram

log = logging.getLogger(__name__)


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
    import torch

    if not torch.autograd._profiler_enabled():
        yield
        return
    with torch.profiler.record_function(name):
        yield


class SpanRegistry:
    """Thread-safe wall-clock span collection, bounded per name: each name
    is one fixed-bucket :class:`StreamingHistogram`, so ``record`` is O(1)
    and memory is constant however many observations arrive."""

    #: a caller minting span names per request must not grow the registry
    #: without bound; past this, records fold into one overflow name
    MAX_SPAN_NAMES = 1024
    _OVERFLOW = "(overflow)"

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._spans: Dict[str, StreamingHistogram] = {}

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


#: the process-wide registry; every server's ``/metrics`` mounts it
spans = SpanRegistry()


@contextlib.contextmanager
def timed(name: str,
          registry: Optional[SpanRegistry] = None) -> Iterator[None]:
    """Time a block into the span registry and the profiler timeline."""
    reg = registry if registry is not None else spans
    t0 = time.monotonic()
    with annotate(name):
        try:
            yield
        finally:
            reg.record(name, time.monotonic() - t0)
