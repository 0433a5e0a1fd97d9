"""The program's own spans and counters inside a traced run's window.

Under a profiler capture the program keeps its spans (``timed``) and
counts (``count``) in the process registry of
``predictionio_tpu_torch/utils/tracing.py``, on ``time.perf_counter``,
the clock of the traced window's host ends (``run.tracer.host``). These
helpers read what lies inside that window. A program that keeps none (it
records no spans, or is older than its ring) reads None, never 0 and
never an error.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def _registry():
    from predictionio_tpu_torch.utils import tracing

    reg = getattr(tracing, "spans", None)
    return reg if hasattr(reg, "kept") and hasattr(reg, "counted") else None


def _window(run):
    tracer = run.tracer
    if tracer is None or not tracer.done:
        return None
    lo, hi = tracer.host
    return (lo, hi) if hi > lo else None


def spans(run) -> Optional[list]:
    """The program's kept spans that lie wholly inside the traced window
    (None without a window or a ring)."""
    reg, win = _registry(), _window(run)
    if reg is None or win is None:
        return None
    return reg.kept(*win)


def counts(run) -> Optional[Dict[str, int]]:
    """The program's counters summed over the traced window."""
    reg, win = _registry(), _window(run)
    if reg is None or win is None:
        return None
    return reg.counted(*win)


def durations(run, name: str, prefix: bool = False) -> List[float]:
    """Seconds of each kept span named ``name`` (or starting with it,
    with ``prefix``) in the traced window."""
    return [r.end - r.start for r in spans(run) or ()
            if (r.name.startswith(name) if prefix else r.name == name)]


def per_ms(run, names, unit: str) -> Optional[float]:
    """Milliseconds of the spans ``names`` summed, over the number of
    ``unit`` spans (a training, a flush) in the traced window."""
    units = len(durations(run, unit))
    if not units:
        return None
    return 1e3 * sum(sum(durations(run, n)) for n in names) / units
