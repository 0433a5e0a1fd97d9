"""The port's SLO engine, spec loader and capacity gate against the JAX
package's (``predictionio_tpu/slo/``), and the SLO surface of the port's
engine server on the CPU.

The same observations on a fake clock go through both engines; every
tick's state, burn rates and budget agree within 1e-12 and the breach
edges are the same. The gate's verdict lines are identical strings.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from datetime import datetime, timezone
from pathlib import Path

import numpy as np
import pytest

import predictionio_tpu.cli as jcli
import predictionio_tpu.obs as jobs
import predictionio_tpu.server.engineserver as jes
import predictionio_tpu.slo as jslo
from predictionio_tpu.obs.trace import Tracer as JTracer
from predictionio_tpu_torch import cli
from predictionio_tpu_torch import faults as pfaults
from predictionio_tpu_torch import obs as pobs
from predictionio_tpu_torch import slo as pslo
from predictionio_tpu_torch.controller.context import Context
from predictionio_tpu_torch.data.storage.base import (
    STATUS_COMPLETED,
    App,
    EngineInstance,
)
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.models.convert import als_model_from_numpy
from predictionio_tpu_torch.obs.trace import Tracer as PTracer
from predictionio_tpu_torch.server.engineserver import (
    QueryServer,
    ServerConfig,
    create_engine_server,
)
from predictionio_tpu_torch.templates.recommendation import (
    recommendation_engine,
)

ROOT = Path(__file__).resolve().parents[1]
CI_SPECS = str(ROOT / "slo" / "specs" / "ci.json")
PKGS = {"jax": (jobs, jslo, JTracer), "port": (pobs, pslo, PTracer)}
SLO_FAMILIES = ("pio_slo_burn_rate", "pio_slo_budget_remaining",
                "pio_slo_breach", "pio_slo_violations_total")
N_USERS, N_ITEMS, RANK = 16, 24, 8

#: loopback only: no proxy from the environment may carry these requests
LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    pfaults.clear()


# -- specs ---------------------------------------------------------------------

BAD_SPECS = [
    dict(name="", objective="availability"),
    dict(name="x", objective="uptime"),
    dict(name="x", objective="availability", target=1.0),
    dict(name="x", objective="availability", target=0.0),
    dict(name="x", objective="latency"),
    dict(name="x", objective="freshness", threshold_ms=-1.0),
    dict(name="x", objective="availability", window_fast_sec=600,
         window_slow_sec=60),
    dict(name="x", objective="availability", window_fast_sec=0),
    dict(name="x", objective="availability", window_slow_sec=3600,
         budget_window_sec=60),
]


@pytest.mark.parametrize("kw", BAD_SPECS, ids=range(len(BAD_SPECS)))
def test_spec_validation_refuses_as_the_jax_spec(kw):
    with pytest.raises(ValueError) as jerr:
        jslo.SLOSpec(**kw)
    with pytest.raises(ValueError) as perr:
        pslo.SLOSpec(**kw)
    assert str(perr.value) == str(jerr.value)


RESOLVE = [
    dict(name="a", objective="availability"),
    dict(name="f", objective="freshness", threshold_ms=1000),
    dict(name="l", objective="latency", threshold_ms=100),
    dict(name="l2", objective="latency", threshold_ms=100,
         scope={"route": "/queries.json"}),
    dict(name="l3", objective="latency", threshold_ms=100,
         scope={"arm": "candidate"}),
    dict(name="l4", objective="latency", threshold_ms=100,
         metric="my_hist"),
]


@pytest.mark.parametrize("kw", RESOLVE, ids=lambda kw: kw["name"])
def test_resolved_metric_and_json_match(kw):
    j, p = jslo.SLOSpec(**kw), pslo.SLOSpec(**kw)
    assert p.resolved_metric() == j.resolved_metric()
    assert p.budget == j.budget
    assert p.to_json() == j.to_json()
    assert pslo.SLOSpec.from_json(p.to_json()) == p


def test_from_json_refuses_unknown_fields_as_the_jax_spec():
    bad = {"name": "x", "objective": "availability", "burn": 2}
    with pytest.raises(ValueError) as jerr:
        jslo.SLOSpec.from_json(bad)
    with pytest.raises(ValueError) as perr:
        pslo.SLOSpec.from_json(bad)
    assert str(perr.value) == str(jerr.value)


def test_the_committed_ci_specs_load_equal():
    jspecs, jgates = jslo.load_specs(CI_SPECS)
    pspecs, pgates = pslo.load_specs(CI_SPECS)
    assert [s.to_json() for s in pspecs] == [s.to_json() for s in jspecs]
    assert pgates == jgates
    assert {s.objective for s in pspecs} == set(pslo.OBJECTIVES)


@pytest.mark.parametrize("doc", [
    {"specs": []},
    {"specs": [{"name": "a", "objective": "availability"}] * 2},
    {"specs": [{"name": "a", "objective": "availability"}],
     "capacity": [1]},
    {"nospecs": 1}], ids=["empty", "duplicate", "capacity-list", "none"])
def test_load_specs_refuses_as_the_jax_loader(tmp_path, doc):
    path = tmp_path / "s.json"
    path.write_text(json.dumps(doc))
    with pytest.raises(ValueError) as jerr:
        jslo.load_specs(str(path))
    with pytest.raises(ValueError) as perr:
        pslo.load_specs(str(path))
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("streaming", [False, True])
def test_default_specs_equal(streaming):
    assert [s.to_json() for s in pslo.default_specs(streaming=streaming)] \
        == [s.to_json() for s in jslo.default_specs(streaming=streaming)]


# -- burn-rate arithmetic on a fake clock ---------------------------------------

AVAIL = dict(name="avail", objective="availability", target=0.9,
             scope={"route": "/q"}, window_fast_sec=5,
             window_slow_sec=20, budget_window_sec=60)


def _avail(ok_rate, bad_rate, **over):
    """Ticks of ``(ok, bad)`` request counts on one route."""
    def drive(fams, t):
        fam = fams["pio_http_requests_total"]
        ok, bad = ok_rate(t), bad_rate(t)
        if ok:
            fam.labels(route="/q", status="200").inc(ok)
        if bad:
            fam.labels(route="/q", status="500").inc(bad)
        fam.labels(route="/other", status="503").inc(3)
    return [dict(AVAIL, **over)], {"pio_http_requests_total": "counter"}, \
        drive


def _latency(slow_share, **over):
    spec = dict(name="lat", objective="latency", target=0.9,
                threshold_ms=100.0, burn_fast=1.5, burn_slow=1.5,
                window_fast_sec=5, window_slow_sec=20,
                budget_window_sec=60, **over)

    def drive(fams, t):
        hist = fams["pio_query_latency_seconds"].labels()
        for i in range(10):
            hist.observe(0.5 if i < slow_share(t) else 0.01 + 0.001 * i)
    return [spec], {"pio_query_latency_seconds": "histogram"}, drive


def _freshness():
    spec = dict(name="fresh", objective="freshness", target=0.9,
                threshold_ms=5000.0, window_fast_sec=5,
                window_slow_sec=15, burn_fast=2.0, burn_slow=2.0,
                budget_window_sec=60)

    def drive(fams, t):
        hist = fams["pio_stream_freshness_seconds"].labels()
        hist.observe(12.0 if 20 <= t < 45 else 0.3 + 0.01 * (t % 7))
    return [spec], {"pio_stream_freshness_seconds": "histogram"}, drive


def _scoped():
    specs = [dict(AVAIL, name="route-a", scope={"route": "/a"},
                  burn_fast=2.0, burn_slow=2.0),
             dict(AVAIL, name="route-b", scope={"route": "/b"},
                  burn_fast=2.0, burn_slow=2.0)]

    def drive(fams, t):
        fam = fams["pio_http_requests_total"]
        fam.labels(route="/a", status="200").inc(5)
        fam.labels(route="/a", status="500").inc(5)
        fam.labels(route="/b", status="200").inc(10)
    return specs, {"pio_http_requests_total": "counter"}, drive


def _idle():
    def drive(fams, t):
        fams["pio_http_requests_total"].labels(
            route="/q", status="200").inc(0)
    return [AVAIL], {"pio_http_requests_total": "counter"}, drive


SCENARIOS = {
    "constant-errors": lambda: _avail(lambda t: 5, lambda t: 5),
    "exhaust-at-budget": lambda: _avail(lambda t: 90, lambda t: 10),
    "half-budget": lambda: _avail(lambda t: 95, lambda t: 5),
    "breach-then-recover": lambda: _avail(
        lambda t: 10 if t < 30 or t >= 70 else 5,
        lambda t: 0 if t < 30 or t >= 70 else 5,
        burn_fast=2.0, burn_slow=2.0),
    "cold-window": lambda: _avail(lambda t: 0, lambda t: 10,
                                  burn_fast=1.0, burn_slow=1.0),
    "latency-buckets": lambda: _latency(lambda t: 3),
    "latency-burst": lambda: _latency(lambda t: 6 if 25 <= t < 50 else 0),
    "freshness": _freshness,
    "scoped-routes": _scoped,
    "idle": _idle,
}


def run_engine(pkg: str, scenario: str, ticks: int = 140):
    """Drive one package's engine through a scenario on a fake clock:
    ``(every tick's status, the transition edges, the exposition)``."""
    obs, slo, _ = PKGS[pkg]
    specs, families, drive = SCENARIOS[scenario]()
    reg = obs.MetricsRegistry()
    fams = {name: (reg.counter(name) if kind == "counter"
                   else reg.histogram(name))
            for name, kind in families.items()}
    clock = [0.0]
    edges = []
    eng = slo.SLOEngine(reg, [slo.SLOSpec(**s) for s in specs],
                        clock=lambda: clock[0],
                        on_transition=lambda s, b, info: edges.append(
                            (s.name, b, info["state"])))
    eng.register_metrics(reg)
    statuses = []
    for t in range(ticks):
        clock[0] = float(t)
        if scenario != "idle" or t >= 5:
            drive(fams, t)
        eng.observe()
        statuses.append(eng.status())
    text = "\n".join(ln for ln in reg.render().splitlines()
                     if ln.startswith("pio_slo_"))
    return statuses, edges, text


def assert_close(p, j, path=""):
    """Nested equality, floats within 1e-12."""
    if isinstance(j, float) and isinstance(p, float):
        assert abs(p - j) <= 1e-12 * max(1.0, abs(j)), (path, p, j)
    elif isinstance(j, dict):
        assert isinstance(p, dict) and set(p) == set(j), (path, p, j)
        for k in j:
            assert_close(p[k], j[k], f"{path}.{k}")
    elif isinstance(j, list):
        assert isinstance(p, list) and len(p) == len(j), (path, p, j)
        for i, (a, b) in enumerate(zip(p, j)):
            assert_close(a, b, f"{path}[{i}]")
    else:
        assert p == j, (path, p, j)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_burn_rates_budgets_and_edges_match(scenario):
    jst, jedges, jtext = run_engine("jax", scenario)
    pst, pedges, ptext = run_engine("port", scenario)
    assert pedges == jedges
    for t, (p, j) in enumerate(zip(pst, jst)):
        assert_close(p, j, f"tick {t}")


def test_the_scenarios_reach_every_state():
    """The scenarios above are not vacuous: between them every state
    and both edges show up."""
    states, edges = set(), set()
    for scenario in SCENARIOS:
        st, ed, _ = run_engine("port", scenario)
        states |= {s["state"] for tick in st for s in tick["specs"]}
        edges |= {b for _, b, _ in ed}
    assert states == {"insufficient_data", "idle", "ok", "breach"}
    assert edges == {True, False}


@pytest.mark.parametrize("scenario", ["breach-then-recover",
                                      "latency-buckets", "scoped-routes"])
def test_the_slo_exposition_matches(scenario):
    _, _, jtext = run_engine("jax", scenario)
    _, _, ptext = run_engine("port", scenario)
    assert ptext == jtext
    for fam in SLO_FAMILIES:
        assert fam in ptext


def test_the_breach_counts_one_violation_and_reads_burning():
    st, edges, text = run_engine("port", "breach-then-recover")
    states = [tick["specs"][0]["state"] for tick in st]
    assert "breach" in states and states[-1] == "ok"
    assert edges == [("avail", True, "breach"), ("avail", False, "ok")]
    assert st[-1]["specs"][0]["violations"] == 1
    assert 'pio_slo_violations_total{slo="avail"} 1' in text


def test_fast_burning_reads_the_fast_window_alone():
    for pkg in PKGS:
        obs, slo, _ = PKGS[pkg]
        reg = obs.MetricsRegistry()
        fam = reg.counter("pio_http_requests_total")
        clock = [0.0]
        eng = slo.SLOEngine(reg, [slo.SLOSpec(**dict(
            AVAIL, burn_fast=2.0, burn_slow=50.0))],
            clock=lambda: clock[0])
        for t in range(40):
            clock[0] = float(t)
            fam.labels(route="/q", status="200").inc(5)
            fam.labels(route="/q", status="500").inc(5 if t > 30 else 0)
            eng.observe()
        assert eng.fast_burning() == ["avail"], pkg
        assert eng.burning() == [], pkg


def test_duplicate_and_empty_specs_refused_as_the_jax_engine():
    for specs in ([], [AVAIL, AVAIL]):
        with pytest.raises(ValueError) as jerr:
            jslo.SLOEngine(jobs.MetricsRegistry(),
                           [jslo.SLOSpec(**s) for s in specs])
        with pytest.raises(ValueError) as perr:
            pslo.SLOEngine(pobs.MetricsRegistry(),
                           [pslo.SLOSpec(**s) for s in specs])
        assert str(perr.value) == str(jerr.value)


def _slo_threads():
    """The live ``slo-engine`` threads: a test holds its own to those it
    found at its start (a server another test file left running in this
    process is not its)."""
    return {t for t in threading.enumerate()
            if t.name == "slo-engine" and t.is_alive()}


def test_the_tick_thread_starts_once_and_is_joined():
    others = _slo_threads()
    reg = pobs.MetricsRegistry()
    reg.counter("pio_http_requests_total").labels(
        route="/q", status="200").inc()
    eng = pslo.SLOEngine(reg, [pslo.SLOSpec(**AVAIL)])
    with pytest.raises(ValueError):
        eng.start(0)
    eng.start(0.01)
    eng.start(0.01)  # idempotent
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and eng.status()["ticks"] < 3:
        time.sleep(0.01)
    assert eng.status()["running"] and eng.status()["ticks"] >= 3
    assert [t.name for t in threading.enumerate()].count("slo-engine") >= 1
    eng.stop()
    eng.stop()  # idempotent
    assert not eng.status()["running"]
    assert not _slo_threads() - others


def retention_run(pkg):
    """The server's breach hook in miniature: while a spec burns, a
    healthy trace is kept under reason ``slo``; an errored one keeps
    ``error``; after recovery nothing healthy is kept."""
    obs, slo, tracer_cls = PKGS[pkg]
    reg = obs.MetricsRegistry()
    fam = reg.counter("pio_http_requests_total")
    clock = [0.0]
    eng = slo.SLOEngine(reg, [slo.SLOSpec(**dict(
        AVAIL, burn_fast=2.0, burn_slow=2.0))], clock=lambda: clock[0])
    tracer = tracer_cls(ring=16)
    eng.on_transition = lambda s, b, info: tracer.force_retention(
        "slo" if eng.burning() else None)
    out = []
    for lo, hi, bad in ((0, 30, 0), (30, 70, 10), (70, 140, 0)):
        for t in range(lo, hi):
            clock[0] = float(t)
            fam.labels(route="/q", status="500" if bad else "200").inc(10)
            eng.observe()
        for status in (200, 500):
            trace = tracer.begin(f"t{hi}-{status}")
            out.append(tracer.finish(trace, status=status, duration=0.001))
    return out


def test_breach_forces_retention_as_the_jax_hook():
    got = retention_run("port")
    assert got == retention_run("jax")
    assert got[2] == (True, "slo") and got[3] == (True, "error")
    assert got[4] == (False, None)


# -- the capacity gate -----------------------------------------------------------

CAPACITY = {
    "step_sec": 3.0,
    "configs": {
        "staged": {"step_sec": 3.0,
                   "frontier": [{"offered_qps": 8.0},
                                {"offered_qps": 32.0}],
                   "knee_qps": 32.0, "p99_at_80pct_knee_ms": 120.0,
                   "freshness_under_load_ms": 800.0},
        "router": {"knee_qps": 12.0, "p99_at_80pct_knee_ms": 900.0,
                   "device_idle_fraction": 0.4},
    },
}

GATES = {
    "pass": {"staged": {"min_knee_qps": 16.0,
                        "max_p99_at_80pct_knee_ms": 500.0}},
    "knee-regressed": {"staged": {"min_knee_qps": 64.0}},
    "p99-regressed": {"staged": {"max_p99_at_80pct_knee_ms": 100.0},
                      "router": {"max_device_idle_fraction": 0.2}},
    "missing-config": {"sharded": {"min_knee_qps": 1.0}},
    "unmeasured": {"staged": {"max_device_idle_fraction": 0.5}},
    "unknown-key": {"staged": {"min_tps": 5}},
    "committed-ci": None,
}


def gates_of(name):
    if name == "committed-ci":
        return jslo.load_specs(CI_SPECS)[1]
    return GATES[name]


@pytest.mark.parametrize("name", sorted(GATES))
def test_gate_verdicts_are_identical(name):
    gates = gates_of(name)
    got = pslo.gate_capacity(CAPACITY, gates)
    assert got == jslo.gate_capacity(CAPACITY, gates)
    assert (got == []) == (name == "pass")


@pytest.mark.parametrize("name", sorted(GATES))
def test_ratchets_are_identical(name):
    gates = gates_of(name)
    got = pslo.ratchet_gates(CAPACITY, gates)
    assert got == jslo.ratchet_gates(CAPACITY, gates)
    again = pslo.ratchet_gates(CAPACITY, got[0])
    assert again[1] == []  # a fixed point


def test_ratchet_tightens_and_never_loosens():
    new, changes = pslo.ratchet_gates(
        CAPACITY, {"staged": {"min_knee_qps": 16.0,
                              "max_p99_at_80pct_knee_ms": 100.0}})
    assert new["staged"]["min_knee_qps"] == pytest.approx(25.6)
    assert new["staged"]["max_p99_at_80pct_knee_ms"] == 100.0
    assert len(changes) == 1


def test_write_gates_rewrites_only_the_capacity_section(tmp_path):
    doc = {"specs": [{"name": "a", "objective": "availability"}],
           "capacity": {"staged": {"min_knee_qps": 1.0}}}
    jpath, ppath = tmp_path / "j.json", tmp_path / "p.json"
    jpath.write_text(json.dumps(doc))
    ppath.write_text(json.dumps(doc))
    jslo.write_gates(str(jpath), {"staged": {"min_knee_qps": 2.0}})
    pslo.write_gates(str(ppath), {"staged": {"min_knee_qps": 2.0}})
    assert ppath.read_text() == jpath.read_text()
    specs, gates = pslo.load_specs(str(ppath))
    assert specs[0].name == "a" and gates["staged"]["min_knee_qps"] == 2.0
    assert not list(tmp_path.glob("*.tmp.*"))


@pytest.mark.parametrize("gate,update", [
    ({"staged": {"min_knee_qps": 16.0}}, False),
    ({"staged": {"min_knee_qps": 64.0}}, False),
    ({"staged": {"min_knee_qps": 16.0}}, True),
    (None, False)], ids=["pass", "fail", "update", "no-gates"])
def test_slo_check_prints_as_the_jax_cli(tmp_path, capsys, gate, update):
    cap = tmp_path / "CAPACITY.json"
    cap.write_text(json.dumps(CAPACITY))
    runs = {}
    for pkg, main in (("jax", jcli.main), ("port", cli.main)):
        specs = tmp_path / f"{pkg}.json"
        doc = {"specs": [{"name": "a", "objective": "availability"}]}
        if gate is not None:
            doc["capacity"] = gate
        specs.write_text(json.dumps(doc))
        argv = ["slo", "check", "--capacity", str(cap), "--specs",
                str(specs)] + (["--update"] if update else [])
        rc = main(argv) if pkg == "port" else main(argv, storage=object())
        out = capsys.readouterr()
        runs[pkg] = (rc, out.out.replace(str(specs), "SPECS"),
                     json.loads(specs.read_text()).get("capacity"))
    assert runs["port"][0] == runs["jax"][0]
    assert runs["port"][2] == runs["jax"][2]
    if runs["jax"][0] == 0:
        assert runs["port"][1] == runs["jax"][1]


def test_deploy_flags_track_the_server_config():
    args = cli._parser().parse_args(["deploy"])
    cfg = ServerConfig()
    assert (args.slo_specs or None) == cfg.slo_specs
    assert args.slo_interval_ms == cfg.slo_interval_ms == \
        jes.ServerConfig().slo_interval_ms


# -- the engine server's SLO surface ----------------------------------------------

def port_server(**cfg):
    rng = np.random.default_rng(3)
    U = rng.standard_normal((N_USERS, RANK)).astype(np.float32)
    V = rng.standard_normal((N_ITEMS, RANK)).astype(np.float32)
    storage = Storage(env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
    storage.apps().insert(App(0, "sloapp"))
    now = datetime.now(timezone.utc)
    inst = EngineInstance(id="slo0", status=STATUS_COMPLETED,
                          start_time=now, end_time=now, engine_id="slo",
                          engine_version="1", engine_variant="engine.json",
                          engine_factory="synthetic")
    storage.engine_instances().insert(inst)
    engine = recommendation_engine()
    model = als_model_from_numpy(
        U, V, N_USERS, N_ITEMS, {f"u{i}": i for i in range(N_USERS)},
        {f"i{i}": i for i in range(N_ITEMS)}, {"rank": RANK},
        device="cpu")
    qs = QueryServer(engine, engine.params_from_variant(
        {"algorithms": [{"name": "als", "params": {"rank": RANK}}]}),
        [model], ServerConfig(device="cpu", warm_start=False, **cfg), inst,
        Context(device="cpu", _storage=storage))
    return create_engine_server(qs, "127.0.0.1", 0).start_background()


def call(port, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else (
        b"" if method == "POST" else None)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    try:
        resp = LOCAL.open(req, timeout=30)
    except urllib.error.HTTPError as e:
        resp = e
    with resp:
        raw = resp.read()
        ctype = resp.headers.get("Content-Type", "")
        out = json.loads(raw) if "json" in ctype and raw else raw.decode()
        return resp.status, out, dict(resp.headers)


def smoke_specs(tmp_path, **over):
    spec = dict(name="smoke-latency", objective="latency", target=0.9,
                threshold_ms=50.0, scope={"route": "/queries.json"},
                window_fast_sec=0.2, window_slow_sec=0.5,
                budget_window_sec=2.0, burn_fast=1.0, burn_slow=1.0)
    spec.update(over)
    path = tmp_path / "specs.json"
    path.write_text(json.dumps({"specs": [spec]}))
    return str(path)


def test_the_default_server_serves_the_slo_surface():
    others = _slo_threads()
    srv = port_server(slo_interval_ms=20.0)
    try:
        for i in range(6):
            assert call(srv.port, "POST", "/queries.json",
                        {"user": f"u{i}", "num": 3})[0] == 200
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                call(srv.port, "GET", "/slo.json")[1]["ticks"] < 3:
            time.sleep(0.02)
        _, slo, _ = call(srv.port, "GET", "/slo.json")
        assert slo["enabled"] and slo["running"] and slo["ticks"] >= 3
        assert [s["name"] for s in slo["specs"]] == [
            s.name for s in jslo.default_specs()]
        _, status, _ = call(srv.port, "GET", "/status.json")
        assert [s["name"] for s in status["slo"]["specs"]] == [
            s["name"] for s in slo["specs"]]
        _, text, _ = call(srv.port, "GET", "/metrics")
        for fam in SLO_FAMILIES:
            assert f"# TYPE {fam} " in text, fam
        assert 'pio_slo_burn_rate{slo="queries-p99-latency",' \
               'window="fast"}' in text
        _, page, _ = call(srv.port, "GET", "/")
        assert "SLOs: 2 watched" in page and "slo.json" in page
    finally:
        srv.close()
    assert not _slo_threads() - others


def test_a_spec_file_is_loaded_and_a_bad_one_fails_the_deploy(tmp_path):
    srv = port_server(slo_specs=CI_SPECS, slo_interval_ms=50.0)
    try:
        _, slo, _ = call(srv.port, "GET", "/slo.json")
        assert [s["name"] for s in slo["specs"]] == [
            s.name for s in jslo.load_specs(CI_SPECS)[0]]
    finally:
        srv.close()
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"specs": []}))
    before = {t.name for t in threading.enumerate()}
    with pytest.raises(ValueError, match="no 'specs' list"):
        port_server(slo_specs=str(bad), batching=True)
    time.sleep(0.1)
    assert not {t.name for t in threading.enumerate()} - before


def test_slo_interval_zero_turns_the_engine_off():
    before = {t.name for t in threading.enumerate()}
    others = _slo_threads()
    srv = port_server(slo_interval_ms=0)
    try:
        assert srv.query_server.slo is None
        assert not _slo_threads() - others
        _, slo, _ = call(srv.port, "GET", "/slo.json")
        assert slo["enabled"] is False and "hint" in slo
        _, status, _ = call(srv.port, "GET", "/status.json")
        assert status["slo"]["enabled"] is False
        _, text, _ = call(srv.port, "GET", "/metrics")
        for fam in SLO_FAMILIES:
            assert fam not in text
    finally:
        srv.close()
    assert not {t.name for t in threading.enumerate()} - before


def test_a_dispatch_latency_breach_keeps_traces_under_reason_slo(tmp_path):
    """An injected ``serving.dispatch`` latency lights the latency spec;
    while it burns, even a fast healthy query's trace is kept with
    reason ``slo`` (the fault's own traces keep reason ``fault``)."""
    srv = port_server(slo_specs=smoke_specs(tmp_path),
                      slo_interval_ms=20.0, trace_slow_ms=60_000.0,
                      batching=True, max_batch=4, batch_window_ms=1.0)
    qs = srv.query_server
    try:
        pfaults.inject("serving.dispatch", mode="latency", delay_ms=120)
        deadline = time.monotonic() + 20
        reasons = set()
        while time.monotonic() < deadline and not qs.slo.burning():
            _, _, h = call(srv.port, "POST", "/queries.json",
                           {"user": "u1", "num": 3})
            reasons.add(h.get("X-Trace-Retained"))
        assert qs.slo.burning() == ["smoke-latency"]
        assert "fault" in reasons
        pfaults.clear()
        kept = None
        while time.monotonic() < deadline and qs.slo.burning():
            _, _, h = call(srv.port, "POST", "/queries.json",
                           {"user": "u2", "num": 3})
            if h.get("X-Trace-Retained") == "slo":
                kept = h
                break
        assert kept is not None, "no trace kept under reason slo"
        _, tr, _ = call(srv.port, "GET", "/trace.json")
        assert tr["retainedByReason"].get("slo", 0) >= 1
        _, slo, _ = call(srv.port, "GET", "/slo.json")
        assert slo["specs"][0]["violations"] >= 1
        _, text, _ = call(srv.port, "GET", "/metrics")
        assert 'pio_slo_violations_total{slo="smoke-latency"}' in text
    finally:
        pfaults.clear()
        srv.close()


def test_slo_status_prints_as_the_jax_cli(tmp_path, capsys):
    srv = port_server(slo_specs=smoke_specs(tmp_path),
                      slo_interval_ms=20.0)
    try:
        rc = cli.main(["slo", "status", "--port", str(srv.port)])
        out = capsys.readouterr().out
        assert rc == 0 and "smoke-latency" in out
        assert "1 spec(s), none burning" in out
        payload = call(srv.port, "GET", "/slo.json")[1]
        assert jcli._print_slo_payload(payload) == \
            cli._print_slo_payload(payload)
        jout = capsys.readouterr().out
        half = len(jout) // 2
        assert jout[:half] == jout[half:]
    finally:
        srv.close()
    assert cli.main(["slo", "status", "--port", str(srv.port)]) == 1
    assert "unreachable" in capsys.readouterr().err
