"""Serving telemetry of the port (the part of ``predictionio_tpu/obs/``
the serving pipeline needs): :class:`OverlapTracker`, the wall-clock
overlap of the device and the host stages.

Left out (``ROADMAP.md`` queue 1): the metric registry and its
exposition, histograms, traces, hot keys and runtime gauges.
"""

from .overlap import DEVICE_TRACK, OverlapTracker

__all__ = ["DEVICE_TRACK", "OverlapTracker"]
