"""Metric registry and Prometheus text exposition (the port's own copy of
``predictionio_tpu/obs/registry.py``).

One :class:`MetricsRegistry` per engine server backs ``GET /metrics``
(Prometheus text format 0.0.4). Counters, gauges (static or backed by a
callable) and histogram families with labels; everything is thread-safe
and O(1) per observation (histograms are the fixed-bucket kind of
:mod:`.histogram`).

Left out (``ROADMAP.md`` queue 1 items 10 and 14): the OpenMetrics
rendering with exemplars, render-time collectors, the JSON snapshot, and
the fleet's ``export`` and ``remove_matching``.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .histogram import StreamingHistogram

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

LabelItems = Tuple[Tuple[str, str], ...]


def escape_label_value(v: str) -> str:
    """Prometheus label-value escaping: backslash, quote, newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def format_value(v: float) -> str:
    """Exposition value formatting (``+Inf``, integers bare, floats
    repr)."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if f != f:  # NaN
        return "NaN"
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(items: LabelItems, extra: Optional[str] = None) -> str:
    parts = [f'{k}="{escape_label_value(v)}"' for k, v in items]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def render_histogram_lines(name: str, items: LabelItems,
                           hist: StreamingHistogram) -> List[str]:
    """One labeled histogram child -> its ``_bucket``/``_sum``/``_count``
    exposition lines."""
    lines = []
    for le, cum in hist.bucket_counts():
        le_item = 'le="' + format_value(le) + '"'
        lines.append(f"{name}_bucket{_label_str(items, le_item)} {cum}")
    lines.append(f"{name}_sum{_label_str(items)} "
                 f"{format_value(hist.sum)}")
    lines.append(f"{name}_count{_label_str(items)} {hist.count}")
    return lines


def _labels_key(labels: Dict[str, str]) -> LabelItems:
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter child."""

    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Gauge child: ``set()`` a value or back it with a callable."""

    __slots__ = ("_value", "_fn")

    def __init__(self, fn: Optional[Callable[[], float]] = None) -> None:
        self._value = 0.0
        self._fn = fn

    def set(self, value: float) -> None:
        self._value = float(value)

    def set_fn(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001 — a broken gauge reads 0,
                return 0.0     # it never breaks the scrape
        return self._value


class _Family:
    """A named metric family: children keyed by their label items."""

    def __init__(self, name: str, help: str, kind: str,
                 bounds: Optional[Sequence[float]] = None) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self.kind = kind
        self._bounds = bounds
        self._children: Dict[LabelItems, Any] = {}
        self._lock = threading.Lock()

    def _make_child(self) -> Any:
        if self.kind == "counter":
            return Counter()
        if self.kind == "gauge":
            return Gauge()
        return StreamingHistogram(self._bounds)

    def labels(self, **labels: str) -> Any:
        key = _labels_key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
        return child

    # unlabeled convenience: the family acts as its own sole child
    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def set_fn(self, fn: Callable[[], float]) -> None:
        self.labels().set_fn(fn)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    def children(self) -> List[Tuple[LabelItems, Any]]:
        with self._lock:
            return list(self._children.items())

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.kind}"]
        for items, child in sorted(self.children(), key=lambda c: c[0]):
            if self.kind == "histogram":
                lines.extend(render_histogram_lines(self.name, items,
                                                    child))
            else:
                lines.append(f"{self.name}{_label_str(items)} "
                             f"{format_value(child.value)}")
        return lines


class MetricsRegistry:
    """Ordered family registry; renders the 0.0.4 text exposition."""

    def __init__(self) -> None:
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _family(self, name: str, help: str, kind: str,
                bounds: Optional[Sequence[float]] = None) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, help, kind, bounds)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}")
        return fam

    def families(self) -> List[_Family]:
        """Every registered family, in registration order."""
        with self._lock:
            return list(self._families.values())

    def counter(self, name: str, help: str = "") -> _Family:
        return self._family(name, help, "counter")

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], float]] = None) -> _Family:
        fam = self._family(name, help, "gauge")
        if fn is not None:
            fam.set_fn(fn)
        return fam

    def histogram(self, name: str, help: str = "",
                  bounds: Optional[Sequence[float]] = None) -> _Family:
        return self._family(name, help, "histogram", bounds)

    def render(self) -> str:
        """Text exposition, Prometheus format 0.0.4."""
        lines: List[str] = []
        for fam in self.families():
            lines.extend(fam.render())
        return "\n".join(lines) + "\n"
