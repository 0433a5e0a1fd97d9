"""The port's telemetry core against the JAX package's, on the same inputs:
the registry's three expositions (byte for byte), histogram exemplars,
the span registry, the hot-key sketch, W3C trace context, the flight
recorder's retention decisions, the trace export, the runtime gauges (no
scrape may initialize CUDA) and the NaN/Inf sentinel's core.

Counts, names and bodies are compared exactly; histogram sums exactly
where the observations are given by the test, never where they are wall
times.
"""

import json
import math
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from predictionio_tpu.obs import hotkeys as jhot
from predictionio_tpu.obs import numerics as jnum
from predictionio_tpu.obs import registry as jreg
from predictionio_tpu.obs import runtime as jrt
from predictionio_tpu.obs import trace as jtrace
from predictionio_tpu.obs.histogram import StreamingHistogram as JHist
from predictionio_tpu.utils import tracing as jtracing
from predictionio_tpu_torch import obs as pobs
from predictionio_tpu_torch.obs import hotkeys as phot
from predictionio_tpu_torch.obs import numerics as pnum
from predictionio_tpu_torch.obs import registry as preg
from predictionio_tpu_torch.obs import runtime as prt
from predictionio_tpu_torch.obs import trace as ptrace
from predictionio_tpu_torch.obs.histogram import StreamingHistogram as PHist
from predictionio_tpu_torch.utils import tracing as ptracing

# -- the registry and its expositions -----------------------------------------


def fill(reg, seed: int) -> None:
    """The same families, children, observations and exemplars in either
    package's registry, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    c = reg.counter("pio_things_total", "Things, by kind")
    for kind in ("a", "b\n\"quoted\"", "c\\d"):
        c.labels(kind=kind).inc(float(rng.integers(0, 50)))
    reg.counter("pio_plain_total", "An unlabeled counter").inc(3.5)
    g = reg.gauge("pio_level", "A gauge with a help line\nand a newline")
    g.labels(side="up").set(float(rng.standard_normal()))
    g.labels(side="down").set(-math.inf)
    reg.gauge("pio_fn_gauge", "Read at scrape", fn=lambda: 42.0)
    h = reg.histogram("pio_latency_seconds", "Latency by route")
    values = rng.exponential(0.01, size=64)
    for i, v in enumerate(values):
        child = h.labels(route="/q" if i % 3 else "/r")
        child.observe(float(v))
        if i % 7 == 0:
            child.record_exemplar(float(v), f"{i:032x}", ts=1700000000.5 + i)
    o = reg.histogram("pio_occupancy", "Batch sizes",
                      bounds=[float(1 << i) for i in range(11)])
    for v in rng.integers(1, 3000, size=40):
        o.observe(float(v))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("openmetrics", [False, True],
                         ids=["text-0.0.4", "openmetrics"])
def test_exposition_is_byte_equal(seed, openmetrics):
    want, got = jreg.MetricsRegistry(), preg.MetricsRegistry()
    fill(want, seed)
    fill(got, seed)
    assert got.render(openmetrics=openmetrics) \
        == want.render(openmetrics=openmetrics)


@pytest.mark.parametrize("seed", [0, 3])
def test_export_and_snapshot_are_equal(seed):
    want, got = jreg.MetricsRegistry(), preg.MetricsRegistry()
    fill(want, seed)
    fill(got, seed)
    assert json.dumps(got.export()) == json.dumps(want.export())
    assert got.snapshot() == want.snapshot()


def test_collectors_render_after_the_families_and_a_bad_one_is_skipped():
    for mod in (jreg, preg):
        reg = mod.MetricsRegistry()
        reg.counter("pio_x_total", "x").inc()
        reg.register_collector(lambda: ["# extra line"])
        reg.register_collector(lambda: 1 / 0)
        text = reg.render()
        assert text.endswith("pio_x_total 1\n# extra line\n")
    assert preg.MetricsRegistry().get("nope") is None


def test_histogram_exemplars_and_reset_match():
    want, got = JHist(), PHist()
    for h in (want, got):
        for v, tid in ((0.0003, "t1"), (0.05, "t2"), (0.051, "t3"),
                       (500.0, "t4")):
            h.observe(v)
            h.record_exemplar(v, tid, ts=12.5)
    assert got.exemplars() == want.exemplars()
    assert got.snapshot() == want.snapshot()
    for h in (want, got):
        h.reset()
    assert got.exemplars() == want.exemplars() == {}
    assert got.snapshot() == want.snapshot() == {"count": 0}
    assert pobs.POW2_COUNT_BOUNDS == tuple(
        float(1 << i) for i in range(11))


def test_span_registry_summary_and_exposition_match():
    want, got = jtracing.SpanRegistry(), ptracing.SpanRegistry()
    rng = np.random.default_rng(5)
    for name in ("load", "warm", "serve"):
        for v in rng.exponential(0.02, size=20):
            want.record(name, float(v))
            got.record(name, float(v))
    assert got.summary() == want.summary()
    jr, pr = jreg.MetricsRegistry(), preg.MetricsRegistry()
    from predictionio_tpu.obs import mount_span_metrics as jmount

    jmount(jr, want)
    pobs.mount_span_metrics(pr, got)
    pobs.mount_span_metrics(pr, got)  # idempotent: no duplicate series
    assert pr.render() == jr.render()


def test_timed_records_into_the_process_registry():
    ptracing.spans.reset()
    with ptracing.timed("unit-span"):
        pass
    assert ptracing.spans.summary()["unit-span"]["count"] == 1
    ptracing.spans.reset()


# -- hot keys -------------------------------------------------------------------

KEYS = hst.lists(hst.sampled_from([f"u{i}" for i in range(40)] + ["", None]),
                 min_size=0, max_size=300)


@pytest.mark.parametrize("capacity", [1, 8, 128])
@settings(derandomize=True, max_examples=40, deadline=None)
@given(stream=KEYS)
def test_space_saving_snapshots_match(capacity, stream):
    want, got = jhot.SpaceSaving(capacity), phot.SpaceSaving(capacity)
    for key in stream:
        want.record(key)
        got.record(key)
    assert got.snapshot(n=capacity) == want.snapshot(n=capacity)
    assert got.top() == want.top()


def test_hot_key_exposition_matches():
    regs = (jreg.MetricsRegistry(), preg.MetricsRegistry())
    sketches = (jhot.SpaceSaving(8), phot.SpaceSaving(8))
    jhot.mount_hot_key_metrics(regs[0], sketches[0])
    phot.mount_hot_key_metrics(regs[1], sketches[1])
    for sk in sketches:
        for k in ("u1", "u2", "u1", 'we"ird', "u1"):
            sk.record(k)
    assert regs[1].render() == regs[0].render()


# -- traces ---------------------------------------------------------------------

TRACEPARENTS = [
    None, "", "garbage",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    " 00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-00 ",
    "ff-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-00000000000000000000000000000000-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-0000000000000000-01",
    "00-0af7651916cd43dd8448eb211c80319-b7ad6b7169203331-01",
    "01-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-09",
]


@pytest.mark.parametrize("header", TRACEPARENTS)
def test_traceparent_parsing_matches(header):
    assert ptrace.parse_traceparent(header) \
        == jtrace.parse_traceparent(header)


@pytest.mark.parametrize("sampled", [True, False])
def test_traceparent_formatting_matches(sampled):
    args = ("0af7651916cd43dd8448eb211c80319c", "b7ad6b7169203331")
    assert ptrace.format_traceparent(*args, sampled=sampled) \
        == jtrace.format_traceparent(*args, sampled=sampled)


def retention(mod, durations, statuses, marks, **tracer_kw):
    """Feed one duration/status/mark sequence to a package's Tracer; the
    decisions and the tracer's status with the random ids left out."""
    tracer = mod.Tracer(**tracer_kw)
    out = []
    for i, (d, st, mk) in enumerate(zip(durations, statuses, marks)):
        if i == len(durations) // 2:
            tracer.force_retention("slo")
        if i == 3 * len(durations) // 4:
            tracer.force_retention(None)
        tr = tracer.begin(f"req-{i}", request_id=str(i))
        if mk:
            tr.mark(mk)
        out.append(tracer.finish(tr, status=st, duration=d))
    status = tracer.status()
    status["recent"] = [(t["name"], t["reason"], t["durationMs"])
                        for t in status["recent"]]
    return out, status


@pytest.mark.parametrize("kw", [
    {}, {"slow_ms": 20.0}, {"slow_floor_ms": 5.0, "min_samples": 50},
    {"ring": 8, "min_samples": 10}], ids=["adaptive", "fixed", "floor",
                                          "small-ring"])
@pytest.mark.parametrize("seed", [0, 1])
def test_retention_decisions_match(kw, seed):
    rng = np.random.default_rng(seed)
    n = 600
    durations = [float(d) for d in rng.lognormal(-5.0, 1.0, size=n)]
    statuses = [int(s) for s in rng.choice(
        [200, 200, 200, 200, 400, 500, 503], size=n)]
    marks = [("fault" if rng.random() < 0.01 else
              "stream" if rng.random() < 0.01 else None) for _ in range(n)]
    want = retention(jtrace, durations, statuses, marks, **kw)
    got = retention(ptrace, durations, statuses, marks, **kw)
    assert got == want


def built_trace(mod):
    """One trace with fixed clocks, spans and exemplars."""
    tr = mod.Trace("POST /queries.json", parent_span_id="b7ad6b7169203331",
                   trace_id="0af7651916cd43dd8448eb211c80319c",
                   request_id="req-1", attrs={"server": "engineserver"})
    tr.t_mono, tr.t_wall = 100.0, 1700000000.0
    parent = tr.add_span("batch", 100.001, 100.009, batchSize=4)
    mod.add_stage_spans(tr, 100.001, {"assemble": 0.001, "supplement": 0.0,
                                      "dispatch": 0.002, "device_wait": 0.003,
                                      "serve": 0.0005, "readback": 0.0002},
                        parent_id=parent.span_id)
    tr.add_span("queue_wait", 100.0, 100.001, parent_id=parent.span_id)
    tr.mark("stream")
    tr.set_attr("arm", "stable")
    tr.t_end = 100.0123
    tr.status = 200
    tr.retained_reason = "slow"
    return tr


def masked(events: dict) -> dict:
    ids = {}

    def mask(v):
        if isinstance(v, str) and len(v) == 16 and v != "b7ad6b7169203331":
            return ids.setdefault(v, f"span-{len(ids)}")
        return v

    out = json.loads(json.dumps(events))
    for ev in out["traceEvents"]:
        ev["args"] = {k: mask(v) for k, v in ev["args"].items()}
    tp = out["otherData"]["traceparent"].split("-")
    out["otherData"]["traceparent"] = "-".join(tp[:2] + [mask(tp[2])]
                                               + tp[3:])
    return out


def test_trace_events_match_with_the_random_ids_masked():
    want, got = built_trace(jtrace), built_trace(ptrace)
    assert masked(got.to_trace_events()) == masked(want.to_trace_events())
    w, g = want.summary(), got.summary()
    assert {k: v for k, v in g.items() if k != "wallTime"} \
        == {k: v for k, v in w.items() if k != "wallTime"}


def test_a_retained_trace_writes_its_exemplars():
    for mod, hist in ((jtrace, JHist()), (ptrace, PHist())):
        tracer = mod.Tracer(slow_ms=1.0)
        fast, slow = tracer.begin("fast"), tracer.begin("slow")
        fast.exemplar(hist, 0.0001)
        slow.exemplar(hist, 0.5)
        assert tracer.finish(fast, status=200, duration=0.0001) \
            == (False, None)
        assert tracer.finish(slow, status=200, duration=0.5) \
            == (True, "slow")
        ex = hist.exemplars()
        assert [v[0] for v in ex.values()] == [slow.trace_id]
        assert tracer.recorder.get(slow.trace_id) is slow


def test_flight_recorder_evicts_the_oldest_and_orders_the_slowest():
    for mod in (jtrace, ptrace):
        rec = mod.FlightRecorder(capacity=3)
        traces = []
        for i, d in enumerate((0.3, 0.1, 0.5, 0.2)):
            t = mod.Trace(f"t{i}")
            t.t_end = t.t_mono + d
            rec.add(t)
            traces.append(t)
        assert len(rec) == 3 and rec.dropped == 1
        assert rec.get(traces[0].trace_id) is None
        assert [t.name for t in rec.slowest(2)] == ["t2", "t3"]


def test_trace_metrics_families_match():
    jr, pr = jreg.MetricsRegistry(), preg.MetricsRegistry()
    jtrace.Tracer().register_metrics(jr)
    ptrace.Tracer().register_metrics(pr)
    assert pr.render() == jr.render()


def test_write_trace_file(tmp_path):
    tr = built_trace(ptrace)
    path = tmp_path / "t.json"
    ptrace.write_trace_file(tr, str(path))
    assert json.loads(path.read_text()) == json.loads(
        json.dumps(tr.to_trace_events()))


# -- the device profiler --------------------------------------------------------


def test_device_profiler_captures_on_one_thread_and_close_joins(tmp_path):
    prof = ptrace.DeviceProfiler(str(tmp_path))
    with pytest.raises(ValueError):
        prof.start(0)
    info = prof.start(60_000.0)  # close() ends the window early
    assert prof.active
    with pytest.raises(RuntimeError, match="already running"):
        prof.start(100.0)
    with pytest.raises(RuntimeError, match="already running"):
        with ptrace.profiler_held():
            pass
    torch.ones(8).sum()
    prof.close()
    assert not prof.active
    assert not [t for t in threading.enumerate()
                if t.name == "device-profiler"]
    st = prof.status()
    assert st["history"][-1]["done"] and "error" not in st["history"][-1]
    assert (tmp_path / info["dir"].split("/")[-1] / "trace.json").is_file()
    with ptrace.profiler_held():  # released again
        with pytest.raises(RuntimeError, match="already running"):
            prof.start(100.0)


# -- runtime --------------------------------------------------------------------


def test_no_scrape_initializes_cuda(monkeypatch):
    """On a CPU torch (and before any CUDA use) the card's memory is
    absent and a scrape never asks CUDA for it."""

    def boom(*a, **k):
        raise AssertionError("a scrape called torch.cuda.memory_stats")

    monkeypatch.setattr(torch.cuda, "memory_stats", boom)
    monkeypatch.setattr(torch.cuda, "get_device_properties", boom)
    assert prt.hbm_stats() == []
    reg = preg.MetricsRegistry()
    prt.register_runtime_metrics(reg, "eventserver")
    text = reg.render()
    assert "pio_device_hbm_bytes" not in text
    assert not torch.cuda.is_initialized()


def test_the_card_memory_gauge_reads_allocated_bytes(monkeypatch):
    """Once CUDA is initialized: used and peak are the allocator's
    allocated bytes, limit the card's total memory."""

    class Props:
        name = "NVIDIA H100 80GB HBM3"
        total_memory = 85_000_000_000

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props())
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": 1234,
        "allocated_bytes.all.peak": 5678,
        "reserved_bytes.all.current": 99999})
    assert prt.hbm_stats() == [{
        "device": "cuda:0", "kind": "NVIDIA H100 80GB HBM3",
        "bytesInUse": 1234, "bytesLimit": 85_000_000_000,
        "peakBytesInUse": 5678}]
    reg = preg.MetricsRegistry()
    prt.register_runtime_metrics(reg, "engineserver")
    text = reg.render()
    assert ('pio_device_hbm_bytes{device="cuda:0",kind="NVIDIA H100 80GB '
            'HBM3",stat="used"} 1234') in text
    assert 'stat="limit"} 85000000000' in text
    assert 'stat="peak"} 5678' in text


def families(text: str) -> set:
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


def test_runtime_families_match_less_the_xla_ones():
    jr, pr = jreg.MetricsRegistry(), preg.MetricsRegistry()
    jrt.register_runtime_metrics(jr, "eventserver")
    prt.register_runtime_metrics(pr, "eventserver")
    prt.register_runtime_metrics(pr, "eventserver")  # once a registry
    # ROADMAP "decided not to port": the XLA sentinels
    xla = {"pio_xla_compiles_total", "pio_transfer_guard_violations_total"}
    assert families(pr.render()) == families(jr.render()) - xla
    info = prt.build_info("eventserver", "9.9")
    assert info == {"server": "eventserver", "version": "9.9",
                    "torch": torch.__version__,
                    "cuda": torch.version.cuda or "none",
                    "process_count": 0, "devices": 0}
    assert set(prt.process_stats()) == set(jrt.process_stats())


# -- the NaN/Inf sentinel -------------------------------------------------------


@pytest.fixture()
def sentinels():
    jnum.reset_for_tests()
    pnum.reset_for_tests()
    yield
    jnum.reset_for_tests()
    pnum.reset_for_tests()


@pytest.mark.parametrize("case", [
    (np.ones(3, np.float32), False), (np.array([1.0, np.nan]), False),
    (np.array([np.inf], np.float32), False),
    (np.array([1.0, -np.inf], np.float32), True),
    (np.array([np.nan], np.float32), True), (np.array([1, 2]), False)],
    ids=["clean", "nan", "inf", "masked-inf", "nan-only", "ints"])
def test_check_array_matches(sentinels, case):
    arr, nan_only = case
    for mod in (jnum, pnum):
        assert mod.check_array("e", arr, nan_only=nan_only)  # off: clean
        assert mod.stats() == {}
        mod.enable()
    assert pnum.check_array("e", arr, nan_only=nan_only) \
        == jnum.check_array("e", arr, nan_only=nan_only)
    assert pnum.stats() == jnum.stats()
    assert pnum.nonfinite_seen() == jnum.nonfinite_seen()


def test_checked_call_sweeps_the_outputs_on_their_device(sentinels):
    assert pnum.checked_call("solve", lambda x: x * 2, 3) == 6
    assert pnum.stats() == {}
    pnum.enable()
    events = []
    pnum.add_listener(lambda e, bad: events.append((e, bad)))
    pnum.add_listener(lambda e, bad: 1 / 0)  # swallowed
    pnum.checked_call("solve", lambda x: x * 2.0, torch.ones(4))
    pnum.checked_call("solve", lambda x: (x * np.nan, x.long()),
                      torch.ones(2))
    assert pnum.stats() == {"solve": {"checks": 2, "nonfinite": 1}}
    assert events == [("solve", False), ("solve", True)]
    assert pnum.nonfinite_seen()


def test_debug_env_arms_like_jax(sentinels, monkeypatch):
    for value, want in (("1", True), ("on", True), ("0", False),
                        ("", False)):
        monkeypatch.setenv("PTPU_DEBUG_NUMERICS", value)
        assert pnum.debug_env() == jnum.debug_env() == want
