"""Serving telemetry of the port (the part of ``predictionio_tpu/obs/``
the serving pipeline and the release rollout need):
:class:`OverlapTracker`, the wall-clock overlap of the device and the host
stages; :class:`MetricsRegistry`, the families behind ``GET /metrics``;
:class:`StreamingHistogram` and :func:`window_quantile`, the latency
series the rollout health gate windows.

Left out (``ROADMAP.md`` queue 1 item 10): traces, hot keys, runtime
gauges, and every metric family but the ``pio_release_*``,
``pio_serving_warm`` and ``pio_warmup_seconds`` ones.
"""

from .histogram import StreamingHistogram, window_quantile
from .overlap import DEVICE_TRACK, OverlapTracker
from .registry import MetricsRegistry

__all__ = ["DEVICE_TRACK", "MetricsRegistry", "OverlapTracker",
           "StreamingHistogram", "window_quantile"]
