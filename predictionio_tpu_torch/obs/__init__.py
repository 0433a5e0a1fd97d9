"""Telemetry of the port (its copy of ``predictionio_tpu/obs/``): streaming
histograms, the metric registry and its expositions, request traces and
the flight recorder, the bounded ``torch.profiler`` capture, hot keys,
runtime gauges, the NaN/Inf sentinels (:mod:`.numerics`) and the overlap
accounting of the staged pipeline.

Every server mounts a :class:`MetricsRegistry` whose contents are served
as Prometheus text or OpenMetrics on ``GET /metrics`` and as JSON on
``GET /metrics.json`` (``server/http.py::mount_metrics``).

Left out: ``TransferGuardCounter`` (XLA transfer logging, ``ROADMAP.md``
"decided not to port").
"""

from .histogram import (
    DEFAULT_LATENCY_BOUNDS,
    POW2_COUNT_BOUNDS,
    StreamingHistogram,
    exponential_bounds,
    linear_bounds,
    window_quantile,
)
from .hotkeys import SpaceSaving, mount_hot_key_metrics
from .overlap import DEVICE_TRACK, OverlapTracker
from .registry import (
    MetricsRegistry,
    escape_label_value,
    format_value,
    render_histogram_lines,
)
from .runtime import (
    build_info,
    hbm_stats,
    process_stats,
    register_process_metrics,
    register_runtime_metrics,
)
from .trace import (
    DeviceProfiler,
    FlightRecorder,
    Trace,
    Tracer,
    activate_traces,
    add_stage_spans,
    mark_active_traces,
)

__all__ = [
    "DEFAULT_LATENCY_BOUNDS",
    "DEVICE_TRACK",
    "POW2_COUNT_BOUNDS",
    "DeviceProfiler",
    "FlightRecorder",
    "MetricsRegistry",
    "OverlapTracker",
    "SpaceSaving",
    "StreamingHistogram",
    "Trace",
    "Tracer",
    "activate_traces",
    "add_stage_spans",
    "build_info",
    "escape_label_value",
    "exponential_bounds",
    "format_value",
    "hbm_stats",
    "linear_bounds",
    "mark_active_traces",
    "mount_hot_key_metrics",
    "mount_span_metrics",
    "process_stats",
    "register_process_metrics",
    "register_runtime_metrics",
    "render_histogram_lines",
    "window_quantile",
]


def mount_span_metrics(reg: MetricsRegistry, span_registry=None,
                       metric_name: str = "pio_span_seconds") -> None:
    """Expose a :class:`..utils.tracing.SpanRegistry`'s histograms (the
    process-wide one by default) as one labeled histogram family on
    ``reg``, through a collector: spans are recorded outside the
    registry's families. Idempotent per registry."""
    from ..utils.tracing import spans as default_spans

    sr = span_registry if span_registry is not None else default_spans
    mounted = getattr(reg, "_span_registries", None)
    if mounted is None:
        mounted = reg._span_registries = set()  # type: ignore[attr-defined]
    if id(sr) in mounted:  # no duplicate series on a remount
        return
    mounted.add(id(sr))

    def collect():
        lines = [f"# HELP {metric_name} Wall-clock spans recorded via "
                 f"utils.tracing.timed(name)",
                 f"# TYPE {metric_name} histogram"]
        for name, hist in sorted(sr.histograms().items()):
            items = (("span", name),)
            lines.extend(render_histogram_lines(metric_name, items,
                                                hist))
        return lines if len(lines) > 2 else []

    reg.register_collector(collect)
