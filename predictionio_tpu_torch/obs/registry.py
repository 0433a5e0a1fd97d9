"""Metric registry and Prometheus exposition (the port's own copy of
``predictionio_tpu/obs/registry.py``).

One :class:`MetricsRegistry` per server process backs ``GET /metrics``
(Prometheus text format 0.0.4, or OpenMetrics 1.0 with bucket exemplars),
``GET /metrics.json`` (:meth:`MetricsRegistry.export`) and the JSON
blocks of ``/status.json`` (:meth:`MetricsRegistry.snapshot`). Counters,
gauges (static or backed by a callable) and histogram families with
labels, plus render-time collectors; everything is thread-safe and O(1)
per observation (histograms are the fixed-bucket kind of
:mod:`.histogram`). :meth:`_Family.remove_matching` drops a departed
fleet replica's children.
"""

from __future__ import annotations

import math
import re
import threading
import time
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Optional,
    Sequence,
    Tuple,
)

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
    """Exposition value formatting (`+Inf`, integers bare, floats repr)."""
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


def _label_str(items: LabelItems,
               extra: Optional[str] = None) -> str:
    parts = [f'{k}="{escape_label_value(v)}"' for k, v in items]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def render_histogram_lines(name: str, items: LabelItems,
                           hist: StreamingHistogram,
                           openmetrics: bool = False) -> List[str]:
    """One labeled histogram child → its ``_bucket``/``_sum``/``_count``
    exposition lines (shared by the registry and the span collector).
    Under OpenMetrics, buckets carrying an exemplar (last retained
    trace id per bucket) render it as ``# {trace_id="…"} value ts`` —
    the grammar Prometheus scrapes exemplars from (exemplars are
    OpenMetrics-only; the 0.0.4 text format has no syntax for them)."""
    exemplars = hist.exemplars() if openmetrics else {}
    lines = []
    for i, (le, cum) in enumerate(hist.bucket_counts()):
        le_item = 'le="' + format_value(le) + '"'
        line = f"{name}_bucket{_label_str(items, le_item)} {cum}"
        ex = exemplars.get(i)
        if ex is not None:
            trace_id, value, ts = ex
            line += (f' # {{trace_id="{escape_label_value(trace_id)}"}}'
                     f" {format_value(value)} {ts:.3f}")
        lines.append(line)
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

    # Unlabeled convenience: family acts as its own sole child.
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

    def remove_matching(self, **labels: str) -> int:
        """Drop every child whose label set CONTAINS the given items
        (``remove_matching(replica="h:p")`` removes that replica's
        children whatever other labels they carry): the fleet aggregator
        calls it when a replica leaves, so membership churn never grows
        the gauges' cardinality. Returns how many went."""
        items = set(labels.items())
        with self._lock:
            doomed = [key for key in self._children
                      if items <= set(key)]
            for key in doomed:
                del self._children[key]
        return len(doomed)

    def render(self, openmetrics: bool = False) -> List[str]:
        # OpenMetrics names a counter family WITHOUT the _total suffix
        # (samples keep it); the 0.0.4 format uses the suffixed name
        # everywhere. Rendering both from one registry is why the
        # family keeps the suffixed name internally.
        meta_name = self.name
        if openmetrics and self.kind == "counter" \
                and meta_name.endswith("_total"):
            meta_name = meta_name[:-len("_total")]
        lines = [f"# HELP {meta_name} {_escape_help(self.help)}",
                 f"# TYPE {meta_name} {self.kind}"]
        for items, child in sorted(self.children()):
            if self.kind == "histogram":
                lines.extend(render_histogram_lines(
                    self.name, items, child, openmetrics=openmetrics))
            else:
                lines.append(f"{self.name}{_label_str(items)} "
                             f"{format_value(child.value)}")
        return lines

    def export(self) -> Dict[str, Any]:
        """Full-fidelity JSON view of the family — unlike
        :meth:`snapshot` (which reduces histograms to percentile
        summaries), this carries the raw cumulative buckets, so a
        fleet aggregator can rebuild and LOSSLESSLY merge the
        histogram (``StreamingHistogram.from_buckets``). ``inf``
        upper bounds render as the string ``"+Inf"`` (JSON has no
        Infinity literal)."""
        children: List[Dict[str, Any]] = []
        for items, child in sorted(self.children()):
            labels = {k: v for k, v in items}
            if self.kind == "histogram":
                buckets = [["+Inf" if math.isinf(le) else le, cum]
                           for le, cum in child.bucket_counts()]
                children.append({
                    "labels": labels,
                    "buckets": buckets,
                    "count": child.count,
                    "sum": child.sum,
                    "min": child.min,
                    "max": child.max,
                })
            else:
                children.append({"labels": labels,
                                 "value": child.value})
        return {"kind": self.kind, "help": self.help,
                "children": children}

    def snapshot(self) -> Any:
        """JSON-friendly view: scalar for the unlabeled child, else a
        ``{"label=value,...": sample}`` map."""
        def one(child: Any) -> Any:
            if self.kind == "histogram":
                return child.snapshot()
            return child.value

        children = self.children()
        if len(children) == 1 and children[0][0] == ():
            return one(children[0][1])
        return {",".join(f"{k}={v}" for k, v in items): one(child)
                for items, child in sorted(children)}


class MetricsRegistry:
    """Ordered family registry; renders 0.0.4 text exposition."""

    def __init__(self) -> None:
        self._families: Dict[str, _Family] = {}
        self._collectors: List[Callable[[], Iterable[str]]] = []
        self._lock = threading.Lock()
        self.start_time = time.time()

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

    def get(self, name: str) -> Optional[_Family]:
        """The registered family called ``name`` (None when absent):
        ``family.kind`` says how to read it, ``family.children()`` yields
        ``(label items, child)`` pairs."""
        with self._lock:
            return self._families.get(name)

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

    def register_collector(
            self, fn: Callable[[], Iterable[str]]) -> None:
        """Append raw (already escaped) exposition lines at render time —
        the hook the span-registry bridge uses."""
        with self._lock:
            self._collectors.append(fn)

    def render(self, openmetrics: bool = False) -> str:
        """Text exposition: Prometheus 0.0.4 by default; OpenMetrics
        1.0 (exemplars on histogram buckets, ``# EOF`` terminator,
        suffix-aware counter metadata) when ``openmetrics`` — the
        format ``Accept: application/openmetrics-text`` negotiates."""
        with self._lock:
            families = list(self._families.values())
            collectors = list(self._collectors)
        lines: List[str] = []
        for fam in families:
            lines.extend(fam.render(openmetrics=openmetrics))
        for fn in collectors:
            try:
                lines.extend(fn())
            except Exception:  # noqa: BLE001 — one bad collector must
                continue       # not take down the whole scrape
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            families = list(self._families.values())
        return {fam.name: fam.snapshot() for fam in families}

    def export(self) -> Dict[str, Any]:
        """Full-fidelity JSON exposition (``GET /metrics.json``): every
        family with kind/help and per-child labels, values, and — for
        histograms — the raw cumulative buckets plus exact
        sum/min/max. This is the fleet-scrape lane: the aggregator
        merges these exactly (counters sum, histogram buckets add),
        which the percentile-summary :meth:`snapshot` cannot support.
        Render-time collectors (build info, HBM) are exposition-only
        and deliberately absent here."""
        with self._lock:
            families = list(self._families.values())
        return {fam.name: fam.export() for fam in families}
