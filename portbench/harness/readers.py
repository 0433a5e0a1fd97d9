"""Arithmetic the per-layer readers share: a kernel's share of its
roofline, the device's idle share, and a host span's mean. Each returns
None where the run holds nothing to read, never 0."""

from __future__ import annotations

from typing import Iterable, Optional

from .peaks import PEAK_OPS, least_seconds


def roofline_share(run, kernels: Iterable[str], least_s: float
                   ) -> Optional[float]:
    """``least_s`` over the device seconds of ``kernels`` in the traced
    window, in percent."""
    s = run.summary
    if s is None or least_s <= 0:
        return None
    t = s.seconds_of(tuple(kernels))
    return None if t <= 0 else 100.0 * least_s / t


def least(ops: float, nbytes: float, precision: str) -> float:
    """The larger of ``ops`` at the precision's peak and ``nbytes`` at
    the memory's rate, seconds."""
    return least_seconds(ops, nbytes, precision)[0]


def mfu(run, ops: float) -> Optional[float]:
    """``ops`` done in the traced window over what the f32 peak would do
    in it, in percent."""
    s = run.summary
    if s is None or ops <= 0 or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * ops / s.window_s / PEAK_OPS["f32"]


def idle_share(run) -> Optional[float]:
    """The share of the traced window with no device operation running,
    in percent."""
    s = run.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def span_mean_ms(run, name: str) -> Optional[float]:
    """Mean milliseconds of the ``name`` spans in the measured window,
    outside its traced sub-window (where the profiler slows the host)."""
    d = run.spans.durations(name, run.window, outside=run.traced_window())
    return None if not d else 1e3 * sum(d) / len(d)
