"""Streaming fixed-bucket histograms: O(1) record, bounded memory (the
port's own copy of ``predictionio_tpu/obs/histogram.py``).

``record`` is one bisect plus one increment, memory is ``len(bounds) + 1``
integers forever, and p50/p90/p99/max are derived at read time by linear
interpolation inside the target bucket (the estimator Prometheus'
``histogram_quantile`` applies to the scraped cumulative buckets). A
bucket may carry an OpenMetrics exemplar: the trace id, value and time of
the last retained trace that landed in it. ``from_buckets`` rebuilds a
histogram from its cumulative buckets and ``merge`` adds another one
bucket by bucket: the fleet aggregator's exact merge.
"""

from __future__ import annotations

import math
import threading
import time
from bisect import bisect_left
from typing import Any, Dict, List, Optional, Sequence, Tuple


def exponential_bounds(start: float, factor: float,
                       count: int) -> List[float]:
    """``count`` log-spaced bucket upper bounds from ``start``."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return [start * factor ** i for i in range(count)]


def linear_bounds(start: float, width: float, count: int) -> List[float]:
    """``count`` evenly spaced bucket upper bounds from ``start``."""
    if width <= 0 or count < 1:
        raise ValueError("need width > 0, count >= 1")
    return [start + width * i for i in range(count)]


#: Default latency buckets: 100 us to ~105 s, x2 per bucket (21 buckets).
DEFAULT_LATENCY_BOUNDS: Tuple[float, ...] = tuple(
    exponential_bounds(0.0001, 2.0, 21))

#: Small-integer buckets (batch occupancy, queue depth): the pow2 ladder
#: 1..1024 of the micro-batcher's batch sizes.
POW2_COUNT_BOUNDS: Tuple[float, ...] = tuple(
    float(1 << i) for i in range(11))


class StreamingHistogram:
    """Thread-safe fixed-bucket histogram.

    ``bounds`` are strictly increasing *inclusive* upper bounds
    (Prometheus ``le`` semantics); one overflow bucket is implicit.
    """

    __slots__ = ("bounds", "_counts", "_count", "_sum", "_min", "_max",
                 "_lock", "_exemplars")

    def __init__(self,
                 bounds: Optional[Sequence[float]] = None) -> None:
        bs = tuple(float(b) for b in
                   (bounds if bounds is not None
                    else DEFAULT_LATENCY_BOUNDS))
        if not bs or any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError("bounds must be non-empty and strictly "
                             "increasing")
        self.bounds = bs
        self._counts = [0] * (len(bs) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()
        # OpenMetrics exemplars, allocated on first use: {bucket index ->
        # (trace_id, value, unix time)}
        self._exemplars: Optional[Dict[int, Tuple[str, float,
                                                  float]]] = None

    @classmethod
    def from_buckets(cls, buckets: Sequence[Tuple[Any, float]],
                     sum: Optional[float] = None,
                     minimum: Optional[float] = None,
                     maximum: Optional[float] = None
                     ) -> "StreamingHistogram":
        """Rebuild a histogram from cumulative ``(le, count)`` pairs, the
        :meth:`bucket_counts` shape, the last ``le`` ``inf`` (or the
        JSON-safe string ``"+Inf"`` of ``/metrics.json``): the inverse of
        a scrape. ``sum``/``minimum``/``maximum`` carry the exact moments
        when known; absent, they are estimated from the bucket edges."""
        if len(buckets) < 2:
            raise ValueError("need at least one finite bucket + +Inf")
        les: List[float] = []
        cums: List[float] = []
        for le, cum in buckets:
            if isinstance(le, str):
                le = math.inf if le in ("+Inf", "inf", "Inf") \
                    else float(le)
            les.append(float(le))
            cums.append(float(cum))
        if not math.isinf(les[-1]):
            raise ValueError("last bucket upper bound must be +Inf")
        hist = cls(bounds=les[:-1])
        prev = 0.0
        counts: List[int] = []
        for cum in cums:
            d = cum - prev
            if d < 0:
                raise ValueError("cumulative bucket counts must be "
                                 "non-decreasing")
            counts.append(int(d))
            prev = cum
        hist._counts = counts
        n = 0
        for c in counts:
            n += c
        hist._count = n
        if n:
            # missing moments from the bucket edges: the lowest occupied
            # bucket's lower edge, the highest one's upper bound (the
            # overflow bucket falls back to the last bound)
            lo_i = next(i for i, c in enumerate(counts) if c)
            hi_i = next(i for i in range(len(counts) - 1, -1, -1)
                        if counts[i])
            est_min = hist.bounds[lo_i - 1] if lo_i > 0 \
                else hist.bounds[0]
            est_max = hist.bounds[min(hi_i, len(hist.bounds) - 1)]
            hist._min = float(minimum) if minimum is not None \
                else est_min
            hist._max = float(maximum) if maximum is not None \
                else est_max
            if sum is not None:
                hist._sum = float(sum)
            else:
                s = 0.0
                for i, c in enumerate(counts):
                    if c:
                        s += c * hist.bounds[min(i, len(hist.bounds)
                                                 - 1)]
                hist._sum = s
        elif sum is not None:
            hist._sum = float(sum)
        return hist

    def merge(self, other: "StreamingHistogram") -> None:
        """Add ``other``'s observations into this histogram, bucket by
        bucket: lossless at bucket resolution, so a quantile of the
        result is the pooled population's, never an average of
        percentiles. The bounds must match exactly. The two locks are
        taken one after the other, never nested."""
        if other.bounds != self.bounds:
            raise ValueError(
                "cannot merge histograms with different bounds "
                f"({len(other.bounds)} vs {len(self.bounds)} buckets)")
        with other._lock:
            counts = list(other._counts)
            n = other._count
            s = other._sum
            lo, hi = other._min, other._max
        if n == 0:
            return
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._count += n
            self._sum += s
            if lo < self._min:
                self._min = lo
            if hi > self._max:
                self._max = hi

    def record(self, value: float) -> None:
        """O(1): one bisect over the fixed bounds + one increment."""
        v = float(value)
        i = bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    # Prometheus naming
    observe = record

    def record_exemplar(self, value: float, trace_id: str,
                        ts: Optional[float] = None) -> None:
        """Attach (or replace) the exemplar of the bucket ``value`` falls
        in: the last retained trace id a bucket, so a ``/metrics`` p99
        bucket links to a ``/trace.json?id=`` lookup (rendered only in
        the OpenMetrics exposition)."""
        v = float(value)
        i = bisect_left(self.bounds, v)
        with self._lock:
            if self._exemplars is None:
                self._exemplars = {}
            self._exemplars[i] = (str(trace_id), v,
                                  ts if ts is not None else time.time())

    def exemplars(self) -> Dict[int, Tuple[str, float, float]]:
        """``{bucket index -> (trace_id, value, ts)}``; index
        ``len(bounds)`` is the overflow (+Inf) bucket."""
        with self._lock:
            return dict(self._exemplars) if self._exemplars else {}

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def max(self) -> float:
        with self._lock:
            return self._max if self._count else 0.0

    @property
    def min(self) -> float:
        with self._lock:
            return self._min if self._count else 0.0

    def bucket_counts(self) -> List[Tuple[float, int]]:
        """Cumulative ``(le, count)`` pairs, ending with ``(inf, n)``: the
        Prometheus exposition shape."""
        with self._lock:
            counts = list(self._counts)
        out: List[Tuple[float, int]] = []
        cum = 0
        for b, c in zip(self.bounds, counts):
            cum += c
            out.append((b, cum))
        out.append((math.inf, cum + counts[-1]))
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Estimate the ``q``-quantile (``q`` in [0, 1]) by linear
        interpolation inside the target bucket; None when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        with self._lock:
            counts = list(self._counts)
            n = self._count
            lo_seen, hi_seen = self._min, self._max
        if n == 0:
            return None
        target = q * n
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.bounds[i - 1] if i > 0 else min(
                    lo_seen, self.bounds[0])
                hi = (self.bounds[i] if i < len(self.bounds)
                      else hi_seen)
                hi = max(hi, lo)
                v = lo + (hi - lo) * ((target - cum) / c)
                # never report outside the observed range
                return min(max(v, lo_seen), hi_seen)
            cum += c
        return hi_seen

    def snapshot(self) -> Dict[str, float]:
        """count/sum/mean/min/max plus the standard percentile trio."""
        with self._lock:
            n, s = self._count, self._sum
        if n == 0:
            return {"count": 0}
        return {
            "count": n,
            "sum": s,
            "mean": s / n,
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * len(self._counts)
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf
            self._exemplars = None


def window_quantile(start: List[Tuple[float, int]],
                    now: List[Tuple[float, int]],
                    q: float) -> Optional[float]:
    """Quantile of the observations that landed BETWEEN two cumulative
    :meth:`StreamingHistogram.bucket_counts` snapshots of one histogram
    (the per-bucket deltas are the window's own histogram; the rollout
    health gate windows candidate-vs-stable p99 this way). Interpolates
    inside the target bucket like :meth:`StreamingHistogram.quantile`;
    None on an empty window, mismatched snapshots, or a *wrapped* window
    (a negative per-bucket delta: the histogram was reset or swapped
    between the snapshots, so the delta is not a histogram of
    anything)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError("q must be in [0, 1]")
    if len(start) != len(now):
        # the bounds changed between snapshots: no sample rather than a
        # mix of the two shapes
        return None
    deltas: List[Tuple[float, int]] = []
    prev_s = prev_n = 0
    for (le_s, cum_s), (le_n, cum_n) in zip(start, now):
        if le_s != le_n:
            return None
        d = (cum_n - prev_n) - (cum_s - prev_s)
        if d < 0:
            return None
        deltas.append((le_n, d))
        prev_s, prev_n = cum_s, cum_n
    total = sum(c for _, c in deltas)
    if total <= 0:
        return None
    target = q * total
    cum = 0
    lo = 0.0
    for le, c in deltas:
        if c > 0 and cum + c >= target:
            hi = lo * 2 if math.isinf(le) else le
            return lo + (max(hi, lo) - lo) * ((target - cum) / c)
        cum += c
        if not math.isinf(le):
            lo = le
    return lo
