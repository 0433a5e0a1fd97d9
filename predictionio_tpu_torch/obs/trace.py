"""End-to-end request tracing: W3C context, a tail-sampled flight
recorder, and bounded ``torch.profiler`` captures (the port's copy of
``predictionio_tpu/obs/trace.py``).

- **Every request is traced.** :meth:`Tracer.begin` parses (or mints) a
  W3C ``traceparent`` and hands back a :class:`Trace` that handlers and
  pipeline stages append :class:`Span` rows to: a few small allocations,
  no I/O, no lock on the span path beyond one list append.
- **Almost every trace is dropped.** :meth:`Tracer.finish` applies the
  tail-sampling policy: a trace is retained only when it was *slow*
  (an adaptive threshold riding the live p99 of the tracer's own
  duration histogram), *errored* (5xx), *deadline-503'd*, marked (a
  fault, a stream fold-in pass) or force-retained. Retained traces land
  in a bounded ring (:class:`FlightRecorder`).
- **Export is Chrome/Perfetto trace-event JSON** (``GET
  /trace.json?id=...``, ``cli trace``), loadable at ui.perfetto.dev.

Batch-stage spans are *reconstructed* timelines: the pipeline records
per-stage durations plus a few wall anchors (enqueue, pickup, dispatch),
and :func:`add_stage_spans` lays the stages out sequentially from each
anchor, so the hops between stage threads show as gaps.

:class:`DeviceProfiler` is the bounded on-demand capture behind ``POST
/profile``: one ``torch.profiler`` window (CPU and, on the card, CUDA
activity) into a served artifact directory, started and stopped on one
thread of its own.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import re
import tempfile
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

from .histogram import StreamingHistogram

__all__ = [
    "Span",
    "Trace",
    "FlightRecorder",
    "Tracer",
    "DeviceProfiler",
    "add_stage_spans",
    "activate_traces",
    "mark_active_traces",
    "parse_traceparent",
    "format_traceparent",
    "profiler_held",
    "write_trace_file",
]

#: W3C trace-context version-00 ``traceparent``:
#: ``00-<32 hex trace-id>-<16 hex parent-id>-<2 hex flags>``
_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")

#: canonical serving-stage order — the sequence the pipeline actually
#: executes, used to lay reconstructed stage spans out on the timeline
STAGE_ORDER = ("queue_wait", "assemble", "supplement", "dispatch",
               "device_wait", "readback", "serve", "feedback")

_ids = random.Random()  # tracing ids need speed, not secrecy


def _new_trace_id() -> str:
    return f"{_ids.getrandbits(128):032x}"


def _new_span_id() -> str:
    return f"{_ids.getrandbits(64):016x}"


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """``(trace_id, parent_span_id)`` from a W3C ``traceparent`` header;
    None on absent/malformed/all-zero values (per spec, an invalid
    header is ignored and a fresh trace is started)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if not m:
        return None
    version, trace_id, span_id, _flags = m.groups()
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def format_traceparent(trace_id: str, span_id: str,
                       sampled: bool = True) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


class Span:
    """One timed operation inside a trace. Times are ``time.monotonic``
    seconds; the owning trace carries the wall-clock anchor."""

    __slots__ = ("name", "span_id", "parent_id", "t_start", "t_end",
                 "attrs")

    def __init__(self, name: str, span_id: str,
                 parent_id: Optional[str], t_start: float,
                 t_end: Optional[float] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.t_start = t_start
        self.t_end = t_end
        self.attrs = attrs


class Trace:
    """One request's (or fold-in pass's) span tree plus its retention
    flags. Span appends take the trace's own lock — traces hop threads
    through the staged pipeline, but contention is two threads at worst
    and the critical section is a list append."""

    __slots__ = ("trace_id", "name", "root_span_id", "parent_span_id",
                 "request_id", "t_mono", "t_wall", "t_end", "status",
                 "marks", "attrs", "spans", "pending_exemplars",
                 "retained_reason", "_lock")

    def __init__(self, name: str, trace_id: Optional[str] = None,
                 parent_span_id: Optional[str] = None,
                 request_id: str = "",
                 attrs: Optional[Dict[str, Any]] = None):
        self.trace_id = trace_id or _new_trace_id()
        self.name = name
        self.root_span_id = _new_span_id()
        self.parent_span_id = parent_span_id
        self.request_id = request_id
        self.t_mono = time.monotonic()
        self.t_wall = time.time()
        self.t_end: Optional[float] = None
        self.status: Optional[int] = None
        self.marks: set = set()
        self.attrs: Dict[str, Any] = dict(attrs or {})
        self.spans: List[Span] = []
        #: deferred exemplar writes: ``(histogram_child, value)`` pairs
        #: applied by :meth:`Tracer.finish` ONLY when the trace is
        #: retained — a /metrics bucket exemplar must point at a trace
        #: that ``/trace.json?id=`` can actually serve
        self.pending_exemplars: List[Tuple[Any, float]] = []
        self._lock = threading.Lock()

    # -- span recording ----------------------------------------------------
    def add_span(self, name: str, t_start: float, t_end: float,
                 parent_id: Optional[str] = None,
                 **attrs: Any) -> Span:
        """Record a completed span with explicit monotonic times."""
        span = Span(name, _new_span_id(),
                    parent_id or self.root_span_id, t_start, t_end,
                    attrs or None)
        with self._lock:
            self.spans.append(span)
        return span

    def span(self, name: str, **attrs: Any):
        """Context manager recording a span around a block."""
        return _SpanCtx(self, name, attrs)

    def mark(self, reason: str) -> None:
        """Flag the trace for retention (``fault``, ``stream``, …)."""
        self.marks.add(reason)

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def exemplar(self, hist_child: Any, value: float) -> None:
        """Defer an exemplar for ``hist_child`` (a
        :class:`~.histogram.StreamingHistogram`) until retention is
        decided."""
        self.pending_exemplars.append((hist_child, value))

    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.root_span_id)

    @property
    def duration(self) -> Optional[float]:
        if self.t_end is None:
            return None
        return self.t_end - self.t_mono

    # -- export ------------------------------------------------------------
    def to_trace_events(self) -> Dict[str, Any]:
        """Chrome/Perfetto trace-event JSON (the ``X`` complete-event
        flavor): microsecond timestamps anchored to the trace's wall
        clock, span tree flattened with parent ids in ``args``."""
        base = self.t_wall - self.t_mono  # mono → wall

        def us(t_mono: float) -> float:
            return round((t_mono + base) * 1e6, 1)

        with self._lock:
            spans = list(self.spans)
        events: List[Dict[str, Any]] = [{
            "name": self.name, "ph": "X", "cat": "request",
            "ts": us(self.t_mono),
            "dur": round((self.duration or 0.0) * 1e6, 1),
            "pid": 1, "tid": 1,
            "args": {"traceId": self.trace_id,
                     "spanId": self.root_span_id,
                     "requestId": self.request_id,
                     "status": self.status,
                     **self.attrs},
        }]
        for s in spans:
            events.append({
                "name": s.name, "ph": "X", "cat": "stage",
                "ts": us(s.t_start),
                "dur": round(((s.t_end or s.t_start) - s.t_start) * 1e6,
                             1),
                "pid": 1, "tid": 1,
                "args": {"spanId": s.span_id,
                         "parentId": s.parent_id,
                         **(s.attrs or {})},
            })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "traceId": self.trace_id,
                "traceparent": self.traceparent(),
                "requestId": self.request_id,
                "name": self.name,
                "retainedReason": self.retained_reason,
                "marks": sorted(self.marks),
            },
        }

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            n_spans = len(self.spans)
        d = self.duration
        return {
            "traceId": self.trace_id,
            "name": self.name,
            "requestId": self.request_id,
            "status": self.status,
            "durationMs": round(d * 1000, 3) if d is not None else None,
            "spans": n_spans,
            "reason": self.retained_reason,
            "marks": sorted(self.marks),
            "attrs": dict(self.attrs),
            "wallTime": self.t_wall,
        }


class _SpanCtx:
    __slots__ = ("trace", "name", "attrs", "t0")

    def __init__(self, trace: Trace, name: str, attrs: Dict[str, Any]):
        self.trace = trace
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_SpanCtx":
        self.t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.attrs = dict(self.attrs, error=str(exc)[:200])
        self.trace.add_span(self.name, self.t0, time.monotonic(),
                            **self.attrs)


def add_stage_spans(trace: Optional[Trace], anchor: float,
                    phases: Dict[str, float],
                    order: Iterable[str] = STAGE_ORDER,
                    parent_id: Optional[str] = None,
                    skip: Iterable[str] = (),
                    **attrs: Any) -> None:
    """Reconstruct a sequential stage timeline from a phases dict
    (stage → duration seconds, the shape ``query_batch`` and
    ``batch_predict`` already produce) laid out from ``anchor``
    onward in canonical ``order``. No-op on a None trace so call
    sites stay branch-free."""
    if trace is None:
        return
    t = anchor
    skipset = set(skip)
    for name in order:
        dur = phases.get(name)
        if dur is None or name in skipset:
            continue
        trace.add_span(name, t, t + dur, parent_id=parent_id, **attrs)
        t += dur


# -- thread-local activation (fault attribution) ---------------------------

_active = threading.local()


class activate_traces:
    """Mark ``traces`` as the ones being worked on by THIS thread, so a
    fault injection delivered here (:func:`mark_active_traces`, wired
    into the engine server's fault listener) flags exactly the traces
    of the batch it hit."""

    __slots__ = ("traces",)

    def __init__(self, traces: Iterable[Optional[Trace]]):
        self.traces = [t for t in traces if t is not None]

    def __enter__(self) -> "activate_traces":
        stack = getattr(_active, "stack", None)
        if stack is None:
            stack = _active.stack = []
        stack.append(self.traces)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        _active.stack.pop()


def mark_active_traces(reason: str, **attrs: Any) -> None:
    """Flag every trace active on the calling thread (fault-injection
    listeners run on the injected thread)."""
    stack = getattr(_active, "stack", None)
    if not stack:
        return
    for traces in stack:
        for t in traces:
            t.mark(reason)
            if attrs:
                t.attrs.update(attrs)


# -- the flight recorder ---------------------------------------------------


class FlightRecorder:
    """Bounded id-addressable ring of retained traces: O(1) insert,
    oldest evicted past capacity (``pio_trace_dropped_total`` counts
    the evictions — a busy tail means raise the ring, not lose data
    silently)."""

    def __init__(self, capacity: int = 512):
        self.capacity = max(int(capacity), 1)
        self._ring: "OrderedDict[str, Trace]" = OrderedDict()
        self._lock = threading.Lock()
        self.dropped = 0

    def add(self, trace: Trace) -> None:
        with self._lock:
            self._ring[trace.trace_id] = trace
            self._ring.move_to_end(trace.trace_id)
            while len(self._ring) > self.capacity:
                self._ring.popitem(last=False)
                self.dropped += 1

    def get(self, trace_id: str) -> Optional[Trace]:
        with self._lock:
            return self._ring.get(trace_id)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def slowest(self, n: int = 10) -> List[Trace]:
        with self._lock:
            traces = list(self._ring.values())
        traces.sort(key=lambda t: t.duration or 0.0, reverse=True)
        return traces[:max(int(n), 0)]

    def recent(self, n: int = 10) -> List[Trace]:
        with self._lock:
            return list(self._ring.values())[-max(int(n), 0):]


class Tracer:
    """Per-server tracer: begins/finishes traces and applies the
    tail-sampling retention policy.

    Retention classes (``pio_trace_retained_total{reason=}``):

    - ``error`` — response status >= 500
    - ``deadline`` — 503 (deadline shed / dependency outage)
    - ``fault`` — a fault injection was delivered during the request
    - ``slow`` — duration >= the adaptive threshold: the live p99 of
      this tracer's own duration histogram once ``min_samples`` have
      been seen (before that, ``slow_floor_ms`` when set, else nothing
      is "slow" yet). A fixed ``slow_ms`` overrides the adaptive rule.
    - ``slo`` (or whatever reason :meth:`force_retention` set): an SLO
      is mid-breach and EVERY trace is evidence, retained until the burn
      clears
    - anything a caller passed to :meth:`Trace.mark` (e.g. ``stream``)
    """

    def __init__(self, ring: int = 512, slow_ms: float = 0.0,
                 slow_floor_ms: float = 0.0, min_samples: int = 200):
        self.recorder = FlightRecorder(ring)
        self.slow_ms = float(slow_ms)
        self.slow_floor_ms = float(slow_floor_ms)
        self.min_samples = int(min_samples)
        self._hist = StreamingHistogram()
        self._started = 0
        self._retained: Dict[str, int] = {}
        self._count_lock = threading.Lock()
        #: while set, finish() retains every trace the normal policy
        #: would drop, under this reason (the SLO engine's burn window:
        #: every violation must arrive with flight-recorder exemplars)
        self._force_reason: Optional[str] = None

    def force_retention(self, reason: Optional[str]) -> None:
        """Turn unconditional retention on (``reason``, e.g. ``"slo"``)
        or back off (None). The ring stays bounded either way — a long
        burn evicts its own oldest evidence, never grows memory."""
        self._force_reason = reason or None

    # -- lifecycle ---------------------------------------------------------
    def begin(self, name: str, traceparent: Optional[str] = None,
              request_id: str = "", **attrs: Any) -> Trace:
        parsed = parse_traceparent(traceparent)
        trace = Trace(
            name,
            trace_id=parsed[0] if parsed else None,
            parent_span_id=parsed[1] if parsed else None,
            request_id=request_id, attrs=attrs)
        with self._count_lock:
            self._started += 1
        return trace

    def slow_threshold(self) -> Optional[float]:
        """Current slow-retention threshold in seconds; None while the
        policy has nothing to compare against."""
        if self.slow_ms > 0:
            return self.slow_ms / 1000.0
        if self._hist.count >= self.min_samples:
            p99 = self._hist.quantile(0.99)
            if p99 is not None:
                return max(p99, self.slow_floor_ms / 1000.0)
        if self.slow_floor_ms > 0:
            return self.slow_floor_ms / 1000.0
        return None

    def finish(self, trace: Trace, status: Optional[int] = None,
               duration: Optional[float] = None,
               force_reason: Optional[str] = None
               ) -> Tuple[bool, Optional[str]]:
        """Close the trace, decide retention, apply deferred exemplars.
        Returns ``(retained, reason)``."""
        now = time.monotonic()
        trace.t_end = now
        if duration is None:
            duration = now - trace.t_mono
        else:
            trace.t_end = trace.t_mono + duration
        trace.status = status
        reason = force_reason
        if reason is None:
            if trace.marks:
                reason = sorted(trace.marks)[0]
            elif status is not None and status == 503:
                reason = "deadline"
            elif status is not None and status >= 500:
                reason = "error"
            else:
                threshold = self.slow_threshold()
                # STRICTLY above: the p99 estimate clamps to the
                # observed max, so a perfectly uniform workload would
                # otherwise retain every request as "slow"
                if threshold is not None and duration > threshold:
                    reason = "slow"
        if reason is None:
            # SLO-burn force-retention is the WEAKEST reason: a trace
            # that is also slow/errored keeps its specific attribution
            reason = self._force_reason
        # the duration feeds the adaptive threshold AFTER the verdict:
        # a single slow burst should be retained against the p99 that
        # preceded it, not against itself
        self._hist.record(duration)
        if reason is None:
            return False, None
        trace.retained_reason = reason
        self.recorder.add(trace)
        with self._count_lock:
            self._retained[reason] = self._retained.get(reason, 0) + 1
        for child, value in trace.pending_exemplars:
            try:
                child.record_exemplar(value, trace.trace_id,
                                      trace.t_wall)
            except Exception:  # noqa: BLE001 — exemplars are advisory
                pass
        return True, reason

    # -- observability -----------------------------------------------------
    def status(self) -> Dict[str, Any]:
        threshold = self.slow_threshold()
        with self._count_lock:
            retained = dict(self._retained)
            started = self._started
        return {
            "requests": started,
            "retained": len(self.recorder),
            "retainedByReason": retained,
            "ringCapacity": self.recorder.capacity,
            "evicted": self.recorder.dropped,
            "slowThresholdMs": (round(threshold * 1000, 3)
                                if threshold is not None else None),
            "forcedReason": self._force_reason,
            "recent": [t.summary() for t in self.recorder.recent(5)],
        }

    def register_metrics(self, registry) -> None:
        """Mount the ``pio_trace_*`` series on ``registry``."""
        registry.gauge(
            "pio_trace_requests_total",
            "Requests traced by the flight recorder (every request is; "
            "retention is the sampled part)",
            # a scrape-time read of a monotonically increasing int
            # (guarded by _count_lock when written); a torn read is at
            # worst one request stale
            fn=lambda: float(self._started))
        retained_fam = registry.gauge(
            "pio_trace_retained_total",
            "Traces retained by the tail sampler, by reason "
            "(slow | error | deadline | fault | stream | slo)")

        def _bind(fam, reason):
            fam.labels(reason=reason).set_fn(
                lambda: float(self._retained.get(reason, 0)))

        for r in ("slow", "error", "deadline", "fault", "stream",
                  "slo"):
            _bind(retained_fam, r)
        registry.gauge(
            "pio_trace_ring_size",
            "Retained traces currently held in the flight-recorder "
            "ring", fn=lambda: float(len(self.recorder)))
        registry.gauge(
            "pio_trace_ring_evicted_total",
            "Retained traces evicted from the ring by newer ones",
            fn=lambda: float(self.recorder.dropped))
        registry.gauge(
            "pio_trace_slow_threshold_seconds",
            "Live slow-retention threshold (adaptive p99 of traced "
            "request durations; 0 until enough samples)",
            fn=lambda: float(self.slow_threshold() or 0.0))


# -- on-demand device profiling --------------------------------------------

#: ``torch.profiler`` is one per process, and a second capture started
#: while one runs corrupts both: every capture in this process (the
#: server's and a script's own) holds this lock for its window
_PROFILER_HELD = threading.Lock()


@contextlib.contextmanager
def profiler_held() -> Iterator[None]:
    """Hold the process's profiler for a capture made outside
    :class:`DeviceProfiler` (raises ``RuntimeError`` while one runs), so
    a ``POST /profile`` meanwhile answers 409 instead of nesting."""
    if not _PROFILER_HELD.acquire(blocking=False):
        raise RuntimeError("a profile capture is already running")
    try:
        yield
    finally:
        _PROFILER_HELD.release()


class DeviceProfiler:
    """Bounded-window ``torch.profiler`` capture into a served artifact
    directory (``POST /profile``). One capture at a time in the process.

    The capture starts and stops on ONE thread, ``device-profiler``:
    :meth:`start` returns once that thread is inside the profiler; the
    thread waits out the window on an event, stops, and writes
    ``trace.json`` (``export_chrome_trace``) into
    ``<base_dir>/profile-<stamp>-<id>/``. :meth:`close` ends a window
    early and joins the thread. CUPTI records the kernels every thread
    launches; CPU operators of other threads may not appear."""

    MAX_WINDOW_MS = 60_000.0

    def __init__(self, base_dir: Optional[str] = None):
        self.base_dir = base_dir or os.environ.get(
            "PTPU_PROFILE_DIR") or os.path.join(
            tempfile.gettempdir(), "ptpu-profiles")
        self._lock = threading.Lock()
        self._active: Optional[Dict[str, Any]] = None
        self._history: List[Dict[str, Any]] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @property
    def active(self) -> bool:
        with self._lock:
            return self._active is not None

    def start(self, duration_ms: float = 1000.0) -> Dict[str, Any]:
        """Begin a capture; ``ValueError`` on a window out of range,
        ``RuntimeError`` when a capture already runs in this process or
        the profiler could not start."""
        duration_ms = float(duration_ms)
        if not 0 < duration_ms <= self.MAX_WINDOW_MS:
            raise ValueError(
                f"durationMs must be in (0, {self.MAX_WINDOW_MS:.0f}]")
        with self._lock:
            if self._active is not None \
                    or not _PROFILER_HELD.acquire(blocking=False):
                raise RuntimeError("a profile capture is already running")
            stamp = time.strftime("%Y%m%d-%H%M%S")
            out_dir = os.path.join(self.base_dir,
                                   f"profile-{stamp}-{_new_span_id()}")
            try:
                os.makedirs(out_dir, exist_ok=True)
            except OSError:
                _PROFILER_HELD.release()
                raise
            info = {"dir": out_dir, "durationMs": duration_ms,
                    "startedAt": time.time(), "done": False}
            self._active = info
            self._stop = threading.Event()
            entered = threading.Event()
            self._thread = threading.Thread(
                target=self._capture,
                args=(info, duration_ms / 1000.0, self._stop, entered),
                daemon=True, name="device-profiler")
            thread = self._thread
        thread.start()
        entered.wait()
        if info.get("error"):
            thread.join()
            raise RuntimeError(f"profiler did not start: {info['error']}")
        return dict(info)

    def _capture(self, info: Dict[str, Any], seconds: float,
                 stop: threading.Event, entered: threading.Event) -> None:
        prof = None
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
        except Exception as e:  # noqa: BLE001 — reported to start()
            info["error"] = str(e)[:500]
            prof = None
        entered.set()
        try:
            if prof is not None:
                stop.wait(seconds)
                prof.stop()
                prof.export_chrome_trace(os.path.join(info["dir"],
                                                      "trace.json"))
        except Exception as e:  # noqa: BLE001 — recorded, never raised
            info["error"] = str(e)[:500]  # on the capture thread
        finally:
            info["done"] = True
            info["stoppedAt"] = time.time()
            with self._lock:
                self._history.append(info)
                self._history = self._history[-20:]
                self._active = None
            _PROFILER_HELD.release()

    def close(self, timeout: float = 10.0) -> None:
        """End a running window now (its trace is still written) and join
        the capture thread."""
        with self._lock:
            thread, stop = self._thread, self._stop
        stop.set()
        if thread is not None:
            thread.join(timeout)

    def status(self) -> Dict[str, Any]:
        with self._lock:
            active = dict(self._active) if self._active else None
            history = [dict(h) for h in self._history]
        artifacts: List[Dict[str, Any]] = []
        try:
            if os.path.isdir(self.base_dir):
                for name in sorted(os.listdir(self.base_dir)):
                    path = os.path.join(self.base_dir, name)
                    if os.path.isdir(path):
                        size = sum(
                            os.path.getsize(os.path.join(root, f))
                            for root, _, files in os.walk(path)
                            for f in files)
                        artifacts.append({"name": name, "dir": path,
                                          "bytes": size})
        except OSError:
            pass
        return {"active": active, "history": history,
                "baseDir": self.base_dir, "artifacts": artifacts}


def write_trace_file(trace: Trace, path: str) -> None:
    """Dump one retained trace as a Perfetto-loadable JSON file (``cli
    trace --id ... -o``)."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace.to_trace_events(), f)
