"""The engine server's telemetry in the port against the JAX package's.

The same rank-8 ALS model (64 users x 40 items, factors from a numpy
seed) is bound in both packages behind HTTP with batching on (the staged
pipeline, or the serial drainers); the same queries go to both, half of
them with a W3C ``traceparent``. With ``trace_slow_ms`` tiny every trace
is retained, so each query's spans can be read back from ``/trace.json``
and compared. The JAX package runs on the CPU through its device path
(``HOST_SERVE_WORK = 0``, test-side only) with ``warm_start=False``; the
port on ``device="cpu"``.

Then the NaN/Inf sentinels at both seams, the profiler capture, the
status page, the stream trainer's ``pio_stream_*`` families and its
``stream.foldin`` pass trace, and the CLI's ``trace`` and deploy flags.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

import predictionio_tpu.models.als as jals
import predictionio_tpu.streaming as jstream
from predictionio_tpu.cache.bus import InvalidationBus as JBus
from predictionio_tpu.controller import Context as JContext
from predictionio_tpu.data.bimap import BiMap as JBiMap
from predictionio_tpu.data.datamap import DataMap as JDataMap
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage import App as JApp
from predictionio_tpu.data.storage import Storage as JStorage
from predictionio_tpu.data.storage.base import STATUS_COMPLETED as J_DONE
from predictionio_tpu.data.storage.base import EngineInstance as JInstance
from predictionio_tpu.obs import numerics as jnum
from predictionio_tpu.server import engineserver as jes
from predictionio_tpu.templates.recommendation import (
    default_engine_params as jax_engine_params,
)
from predictionio_tpu.templates.recommendation import (
    recommendation_engine as jax_engine,
)
from predictionio_tpu.utils import tracing as jtracing
from predictionio_tpu_torch import cli
from predictionio_tpu_torch.analysis.metrics_catalog import LEFT_OUT
from predictionio_tpu_torch.cache.bus import InvalidationBus
from predictionio_tpu_torch.controller.context import Context
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import App, EngineInstance
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.models.convert import als_model_from_numpy
from predictionio_tpu_torch.obs import numerics as pnum
from predictionio_tpu_torch.obs.trace import parse_traceparent
from predictionio_tpu_torch.server import engineserver as es
from predictionio_tpu_torch.server.engineserver import (
    QueryServer,
    ServerConfig,
)
from predictionio_tpu_torch.streaming import StreamConfig, StreamTrainer
from predictionio_tpu_torch.templates.recommendation import (
    recommendation_engine,
)
from predictionio_tpu_torch.utils import tracing as ptracing

N_USERS, N_ITEMS, RANK = 64, 40, 8
APP = "teleapp"
VARIANT = {"algorithms": [{"name": "als", "params": {"rank": RANK}}]}
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)

#: loopback only: no proxy from the environment may carry these requests
LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setattr(jals, "HOST_SERVE_WORK", 0)


@pytest.fixture(autouse=True)
def _sentinels():
    jnum.reset_for_tests()
    pnum.reset_for_tests()
    yield
    jnum.reset_for_tests()
    pnum.reset_for_tests()


@pytest.fixture(scope="module")
def factors():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((N_USERS, RANK)).astype(np.float32),
            rng.standard_normal((N_ITEMS, RANK)).astype(np.float32))


def ids(prefix, n):
    return {f"{prefix}{i}": i for i in range(n)}


def instance(cls, iid="t0"):
    now = datetime.now(timezone.utc)
    return cls(id=iid, status=J_DONE, start_time=now, end_time=now,
               engine_id="tele", engine_version="1",
               engine_variant="engine.json", engine_factory="synthetic")


def jax_server(factors, **cfg):
    U, V = factors
    model = jals.ALSModel(
        user_factors=U, item_factors=V, n_users=N_USERS, n_items=N_ITEMS,
        user_ids=JBiMap(ids("u", N_USERS)),
        item_ids=JBiMap(ids("i", N_ITEMS)),
        params=jals.ALSParams(rank=RANK))
    storage = JStorage(env={"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})
    storage.apps().insert(JApp(0, APP))
    inst = instance(JInstance)
    storage.engine_instances().insert(inst)
    return jes.QueryServer(
        JContext(app_name=APP, _storage=storage), jax_engine(),
        jax_engine_params(APP, rank=RANK), [model], inst,
        jes.ServerConfig(warm_start=False, **cfg))


def port_server(factors, **cfg):
    U, V = factors
    storage = Storage(env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
    storage.apps().insert(App(0, APP))
    inst = instance(EngineInstance)
    storage.engine_instances().insert(inst)
    engine = recommendation_engine()
    model = als_model_from_numpy(U, V, N_USERS, N_ITEMS, ids("u", N_USERS),
                                 ids("i", N_ITEMS), {"rank": RANK},
                                 device="cpu")
    return QueryServer(engine, engine.params_from_variant(VARIANT), [model],
                       ServerConfig(device="cpu", warm_start=False, **cfg),
                       inst, Context(device="cpu", _storage=storage))


def call(port, method, path, body=None, headers=None):
    """``(status, JSON or text body, response headers)``."""
    data = json.dumps(body).encode() if body is not None else (
        b"" if method == "POST" else None)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method,
                                 headers=headers or {})
    try:
        resp = LOCAL.open(req, timeout=30)
    except urllib.error.HTTPError as e:
        resp = e
    with resp:
        raw = resp.read()
        ctype = resp.headers.get("Content-Type", "")
        out = json.loads(raw) if "json" in ctype and raw else raw.decode()
        return resp.status, out, dict(resp.headers)


def families(text: str) -> set:
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


def samples(text: str, name: str) -> dict:
    """``{labels: value}`` of one sample name's lines."""
    out = {}
    for ln in text.splitlines():
        if ln.startswith(name + "{") or ln.startswith(name + " "):
            key, _, value = ln.rpartition(" ")
            out[key[len(name):]] = value
    return out


QUERIES = [{"user": f"u{i}", "num": 3 + i % 5,
            **({"blackList": [f"i{i % 7}"]} if i % 4 == 1 else {})}
           for i in range(24)]


def traceparent(i: int) -> str:
    return f"00-{i + 1:032x}-{i + 7:016x}-01"


@pytest.fixture(params=["staged", "serial"])
def served(request, factors):
    """Both packages behind HTTP, batching with ``request.param``, every
    trace retained; the same queries sent to both, in the same order,
    the odd ones with a traceparent."""
    cfg = dict(batching=True, serving_pipeline=request.param, max_batch=8,
               batch_window_ms=1.0, trace_slow_ms=1e-6)
    # the process-wide ``timed`` spans (``pio_span_seconds``) hold what
    # earlier tests of this worker recorded: clear both packages', so
    # each server renders only its own families
    jtracing.spans.reset()
    ptracing.spans.reset()
    jqs = jax_server(factors, **cfg)
    jsrv = jes.create_engine_server(jqs, "127.0.0.1", 0).start_background()
    psrv = es.create_engine_server(port_server(factors, **cfg), "127.0.0.1",
                                   0).start_background()
    answers = {}
    for pkg, srv in (("jax", jsrv), ("port", psrv)):
        answers[pkg] = [
            call(srv.port, "POST", "/queries.json", q,
                 {"traceparent": traceparent(i)} if i % 2 else {})
            for i, q in enumerate(QUERIES)]
    yield jsrv, psrv, answers
    jsrv.shutdown()
    jqs.close()
    psrv.close()


def test_the_answers_and_their_headers_match(served):
    _, _, answers = served
    for (js, jb, jh), (ps, pb, ph) in zip(answers["jax"], answers["port"]):
        assert ps == js == 200
        assert [s["item"] for s in pb["itemScores"]] \
            == [s["item"] for s in jb["itemScores"]]
        keys = {"X-Request-ID", "traceparent", "X-Trace-Retained"}
        assert keys <= set(ph) and keys <= set(jh)
        assert ph["X-Trace-Retained"] == jh["X-Trace-Retained"] == "slow"
        assert parse_traceparent(ph["traceparent"]) is not None


def test_metric_families_match_less_the_left_out(served):
    jsrv, psrv, _ = served
    _, jtext, _ = call(jsrv.port, "GET", "/metrics")
    _, ptext, _ = call(psrv.port, "GET", "/metrics")
    want, got = families(jtext), families(ptext)
    # the port's batch top-k records its ``topk.*`` spans on every served
    # batch, and the JAX package's serving records none: the span family
    # renders on the port's side alone
    assert got - want == {"pio_span_seconds"}, sorted(got - want)
    assert '{span="topk.dispatch"}' in samples(ptext,
                                               "pio_span_seconds_count")
    assert want - got == set(LEFT_OUT), sorted((want - got) ^ set(LEFT_OUT))


#: the replicated lanes' families (queue 1 item 13): once left out, now
#: emitted by every engine server with the JAX package's names
LANE_FAMILIES = ("pio_lane_batch_seconds", "pio_lane_queue_depth",
                 "pio_lane_dispatches_total", "pio_lane_restarts_total",
                 "pio_lane_failures_total", "pio_serving_lanes",
                 "pio_serving_degraded")


@pytest.mark.parametrize("family", LANE_FAMILIES)
def test_the_lane_families_are_present_not_left_out(served, family):
    jsrv, psrv, _ = served
    _, jtext, _ = call(jsrv.port, "GET", "/metrics")
    _, ptext, _ = call(psrv.port, "GET", "/metrics")
    assert family not in LEFT_OUT
    assert family in families(ptext) and family in families(jtext)


def test_query_counts_match(served):
    jsrv, psrv, _ = served
    _, jtext, _ = call(jsrv.port, "GET", "/metrics")
    _, ptext, _ = call(psrv.port, "GET", "/metrics")
    for name in ("pio_query_latency_seconds_count",
                 "pio_batch_occupancy_sum", "pio_batch_occupancy_count",
                 "pio_http_requests_total",
                 "pio_http_request_duration_seconds_count",
                 "pio_trace_requests_total", "pio_trace_retained_total",
                 "pio_numerics_checks_total"):
        assert samples(ptext, name) == samples(jtext, name), name
    assert samples(ptext, "pio_query_latency_seconds_count") \
        == {"": str(len(QUERIES))}
    # the OpenMetrics exposition with exemplars parses the same way
    _, om, headers = call(psrv.port, "GET", "/metrics",
                          headers={"Accept": "application/openmetrics-text"})
    assert headers["Content-Type"].startswith("application/openmetrics-text")
    assert om.endswith("# EOF\n") and ' # {trace_id="' in om


def span_names(port, trace_id):
    status, body, _ = call(port, "GET", f"/trace.json?id={trace_id}")
    assert status == 200, body
    return [ev["name"] for ev in body["traceEvents"][1:]]


def test_each_query_has_the_same_spans_in_the_same_order(served):
    jsrv, psrv, answers = served
    for i, (j, p) in enumerate(zip(answers["jax"], answers["port"])):
        jt = parse_traceparent(j[2]["traceparent"])[0]
        pt = parse_traceparent(p[2]["traceparent"])[0]
        if i % 2:  # the caller's trace id is kept
            assert pt == jt == traceparent(i).split("-")[1]
        assert span_names(psrv.port, pt) == span_names(jsrv.port, jt), i


def test_the_trace_routes_and_status_blocks_match(served):
    jsrv, psrv, _ = served
    _, jst, _ = call(jsrv.port, "GET", "/trace.json")
    _, pst, _ = call(psrv.port, "GET", "/trace.json")
    assert set(pst) == set(jst)
    assert (pst["requests"], pst["retained"], pst["retainedByReason"]) \
        == (jst["requests"], jst["retained"], jst["retainedByReason"])
    _, jslow, _ = call(jsrv.port, "GET", "/trace.json?slowest=5")
    _, pslow, _ = call(psrv.port, "GET", "/trace.json?slowest=5")
    assert len(pslow["traces"]) == len(jslow["traces"]) == 5
    assert set(pslow["traces"][0]) == set(jslow["traces"][0])
    assert call(psrv.port, "GET", "/trace.json?slowest=x")[0] \
        == call(jsrv.port, "GET", "/trace.json?slowest=x")[0] == 400
    assert call(psrv.port, "GET", "/trace.json?id=nope")[0] \
        == call(jsrv.port, "GET", "/trace.json?id=nope")[0] == 404
    assert call(psrv.port, "GET", "/plugins.json")[1] \
        == call(jsrv.port, "GET", "/plugins.json")[1]
    _, jstatus, _ = call(jsrv.port, "GET", "/status.json")
    _, pstatus, _ = call(psrv.port, "GET", "/status.json")
    assert pstatus["hotKeys"] == jstatus["hotKeys"]
    assert set(pstatus["trace"]) == set(jstatus["trace"])
    assert pstatus["degraded"]["nonfinite"] is jstatus["degraded"][
        "nonfinite"] is False
    for block in ("phases", "latency", "batchOccupancy", "queueDepth"):
        assert set(pstatus[block]) == set(jstatus[block]), block
    assert pstatus["batchOccupancy"]["sum"] \
        == jstatus["batchOccupancy"]["sum"] == len(QUERIES)


def test_metrics_json_exports_the_registry(served):
    _, psrv, _ = served
    _, body, _ = call(psrv.port, "GET", "/metrics.json")
    occ = body["pio_batch_occupancy"]
    assert occ["kind"] == "histogram"
    assert occ["children"][0]["count"] >= 1
    _, text, _ = call(psrv.port, "GET", "/metrics")
    assert 'pio_metrics_render_seconds_count{format="json"} 1' in text


def test_the_candidate_arm_traces_its_serve(factors):
    qs = port_server(factors)
    tracer = qs.tracer
    qs.bind_candidate(qs.instance, models=[qs.models[0]])
    tr = tracer.begin("POST /queries.json")
    out = qs.serve_candidate({"user": "u3", "num": 2},
                             obs={"_trace": tr})
    assert len(out["itemScores"]) == 2
    assert [s.name for s in tr.spans] == ["candidate_serve"]
    assert tr.attrs["arm"] == "candidate"
    qs.close()


def test_the_single_query_path_spans_its_phases(factors):
    j, p = jax_server(factors), port_server(factors)
    for qs in (j, p):
        tr = qs.tracer.begin("POST /queries.json")
        qs.serve({"user": "u5", "num": 3}, obs={"_trace": tr})
        qs.trace_names = [s.name for s in tr.spans]  # noqa: B010
    assert p.trace_names == j.trace_names
    assert p.hotkeys.snapshot() == j.hotkeys.snapshot()
    j.close()
    p.close()


def test_tracing_and_hot_keys_off(factors):
    qs = port_server(factors, tracing=False, hot_keys_k=0)
    srv = es.create_engine_server(qs, "127.0.0.1", 0).start_background()
    try:
        status, _, headers = call(srv.port, "POST", "/queries.json",
                                  {"user": "u1", "num": 2})
        assert status == 200 and "traceparent" not in headers
        assert call(srv.port, "GET", "/trace.json")[0] == 404
        _, st, _ = call(srv.port, "GET", "/status.json")
        assert st["trace"] == st["hotKeys"] == {"enabled": False}
    finally:
        srv.close()


def test_server_config_defaults_match_jax():
    want, got = jes.ServerConfig(), ServerConfig()
    for knob in ("tracing", "trace_ring", "trace_slow_ms",
                 "access_log_sample", "profile_dir", "hot_keys_k",
                 "debug_numerics", "accesskey", "serving_mode",
                 "lane_fail_threshold", "lane_restart_backoff_ms",
                 "lane_restart_max_attempts", "feedback",
                 "feedback_app_name", "log_url", "log_prefix",
                 "batch_window_ms", "serving_topk"):
        assert getattr(got, knob) == getattr(want, knob), knob


def test_the_access_log_samples_successes_and_keeps_errors(factors,
                                                           caplog):
    qs = port_server(factors, access_log_sample=0.0)
    srv = es.create_engine_server(qs, "127.0.0.1", 0).start_background()
    try:
        with caplog.at_level("INFO", logger="predictionio_tpu_torch.access"):
            call(srv.port, "POST", "/queries.json", {"user": "u1"})
            call(srv.port, "POST", "/queries.json", {"bogus": 1})
        lines = [json.loads(r.getMessage()) for r in caplog.records
                 if r.name == "predictionio_tpu_torch.access"]
        assert [ln["status"] for ln in lines] == [400]
        assert lines[0]["traceId"] and lines[0]["requestId"]
    finally:
        srv.close()


# -- the NaN/Inf sentinels -----------------------------------------------------


def test_serve_topk_counts_one_check_a_top_k_call(factors):
    servers = {"jax": jax_server(factors, debug_numerics=True),
               "port": port_server(factors, debug_numerics=True)}
    assert jnum.active() and pnum.active()
    for qs in servers.values():
        for i in range(7):
            qs.query({"user": f"u{i}", "num": 4})
    want = jnum.stats()["serve_topk"]
    got = pnum.stats()["serve_topk"]
    assert got == want == {"checks": 7, "nonfinite": 0}
    for qs in servers.values():
        qs.close()


def test_a_nan_fold_in_degrades_both_servers(factors):
    jqs = jax_server(factors, debug_numerics=True)
    jsrv = jes.create_engine_server(jqs, "127.0.0.1", 0).start_background()
    psrv = es.create_engine_server(
        port_server(factors, debug_numerics=True), "127.0.0.1",
        0).start_background()
    try:
        fixed = np.ones((16, 8), np.float32)
        fixed[0, 0] = np.nan  # one poisoned factor row
        idx = np.zeros((2, 3), np.int32)  # the histories hit row 0
        val = np.ones((2, 3), np.float32)
        cnt = np.full((2,), 3, np.int32)
        jals.fold_in_rows(fixed, idx, val, cnt,
                          jals.ALSParams(rank=8, implicit_prefs=True))
        als.fold_in_rows(torch.from_numpy(fixed), idx, val, cnt,
                         als.ALSParams(rank=8, implicit_prefs=True))
        for srv in (jsrv, psrv):
            _, st, _ = call(srv.port, "GET", "/status.json")
            assert st["degraded"]["nonfinite"] is True
            assert st["degraded"]["active"] is True
            _, text, _ = call(srv.port, "GET", "/metrics")
            assert samples(text, "pio_numerics_nonfinite_total") == {
                '{entry="fold_in_rows"}': "1"}
            assert samples(text, "pio_numerics_checks_total")[
                '{entry="fold_in_rows"}'] == "1"
    finally:
        jsrv.shutdown()
        jqs.close()
        psrv.close()


# -- the profiler capture ------------------------------------------------------


def test_profile_capture_over_http(factors, tmp_path):
    qs = port_server(factors, profile_dir=str(tmp_path))
    srv = es.create_engine_server(qs, "127.0.0.1", 0).start_background()
    try:
        assert call(srv.port, "POST", "/profile",
                    {"durationMs": -1})[0] == 400
        status, body, _ = call(srv.port, "POST", "/profile",
                               {"durationMs": 300})
        assert status == 202 and body["dir"].startswith(str(tmp_path))
        assert call(srv.port, "POST", "/profile",
                    {"durationMs": 300})[0] == 409
        call(srv.port, "POST", "/queries.json", {"user": "u2", "num": 2})
        deadline = time.monotonic() + 30
        while True:
            _, prof, _ = call(srv.port, "GET", "/profile.json")
            if prof["active"] is None and prof["history"]:
                break
            assert time.monotonic() < deadline
            time.sleep(0.05)
        last = prof["history"][-1]
        assert last["done"] and "error" not in last
        assert (tmp_path / last["dir"].rsplit("/", 1)[1]
                / "trace.json").is_file()
        assert [a["name"] for a in prof["artifacts"]] \
            == [last["dir"].rsplit("/", 1)[1]]
        _, st, _ = call(srv.port, "GET", "/status.json")
        assert st["profile"]["captures"] == 1
        # a capture left running is ended and joined by close()
        assert call(srv.port, "POST", "/profile",
                    {"durationMs": 60000})[0] == 202
    finally:
        srv.close()
    assert not [t for t in threading.enumerate()
                if t.name == "device-profiler"]


def test_profile_is_key_guarded(factors):
    qs = port_server(factors, accesskey="SECRET")
    srv = es.create_engine_server(qs, "127.0.0.1", 0).start_background()
    try:
        assert call(srv.port, "POST", "/profile", {"durationMs": 10})[0] \
            == 401
        assert call(srv.port, "POST", "/reload")[0] == 401
        assert call(srv.port, "GET", "/plugins/outputblockers/x")[0] == 401
        assert call(srv.port, "GET",
                    "/plugins/outputblockers/x?accessKey=SECRET")[0] == 404
    finally:
        srv.close()


def test_the_status_page_has_the_span_table_and_the_trace_line(factors):
    qs = port_server(factors)
    srv = es.create_engine_server(qs, "127.0.0.1", 0).start_background()
    try:
        call(srv.port, "POST", "/queries.json", {"user": "u1", "num": 2})
        _, page, _ = call(srv.port, "GET", "/")
        assert "<h2>Latency percentiles</h2>" in page
        assert "phase:assemble" in page and "query (end-to-end)" in page
        assert "flight recorder: " in page
    finally:
        srv.close()


# -- output plugins ------------------------------------------------------------


def test_output_blockers_see_every_served_result(factors):
    from predictionio_tpu_torch.server.plugins import EngineServerPlugin

    class TopOnly(EngineServerPlugin):
        plugin_name = "toponly"

        def process(self, query, prediction):
            return {"itemScores": prediction["itemScores"][:1]}

    for mode in (None, "staged", "serial"):
        qs = port_server(factors, **({"batching": True,
                                      "serving_pipeline": mode}
                                     if mode else {}))
        qs.plugins.register(TopOnly(), blocker=True)
        assert len(qs.serve({"user": "u1", "num": 4})["itemScores"]) == 1
        assert qs.plugins.describe()["outputblockers"]["toponly"][
            "class"].endswith("TopOnly")
        qs.close()


# -- the stream trainer --------------------------------------------------------


def rate(cls, dm, user, item, rating, t, traceparent_=None):
    props = {"rating": rating}
    if traceparent_:
        props["pio_traceparent"] = traceparent_
    return cls(event="rate", entity_type="user", entity_id=user,
               target_entity_type="item", target_entity_id=item,
               properties=dm(props), event_time=t)


def burst_events(cls, dm, k: int):
    """Burst ``k``: ratings by known users and one new user, the first two
    carrying trace contexts."""
    rng = np.random.default_rng(k)
    out = []
    for n in range(12):
        user = f"u{int(rng.integers(0, N_USERS))}" if n < 11 else f"new{k}"
        tp = traceparent(100 * k + n) if n < 2 else None
        out.append(rate(cls, dm, user, f"i{int(rng.integers(0, N_ITEMS))}",
                        float(rng.integers(1, 6)),
                        T0 + timedelta(hours=k, minutes=n), tp))
    return out


def stream_lines(text: str) -> dict:
    """The ``pio_stream_*`` samples, wall-time sums left out."""
    return {ln.rpartition(" ")[0]: ln.rpartition(" ")[2]
            for ln in text.splitlines()
            if ln.startswith("pio_stream_") and "_sum" not in ln
            and "_bucket" not in ln and "drift_score" not in ln}


def test_stream_pass_traces_and_families_match(factors):
    jqs, pqs = jax_server(factors), port_server(factors)
    jtr = jstream.StreamTrainer(jqs, jstream.StreamConfig(
        app_name=APP, canary_probes=0), bus=JBus())
    ptr = StreamTrainer(pqs, StreamConfig(app_name=APP, canary_probes=0),
                        bus=InvalidationBus())
    japp = jqs.ctx.storage.apps().get_by_name(APP).id
    papp = pqs.storage.apps().get_by_name(APP).id
    for k in range(3):
        jqs.ctx.storage.events().insert_batch(
            burst_events(JEvent, JDataMap, k), japp)
        pqs.storage.events().insert_batch(
            burst_events(Event, DataMap, k), papp)
        assert ptr.consume_once() == jtr.consume_once() == 12
        for qs in (jqs, pqs):
            head = parse_traceparent(traceparent(100 * k))
            trace = qs.tracer.recorder.get(head[0])
            assert trace is not None and trace.name == "stream.foldin"
            assert trace.parent_span_id == head[1]
            assert trace.retained_reason == "stream"
            assert trace.attrs["outcome"] == "applied"
            assert trace.attrs["links"] == [
                parse_traceparent(traceparent(100 * k + 1))[0]]
        jtrace = jqs.tracer.recorder.get(head[0])
        ptrace = pqs.tracer.recorder.get(head[0])
        assert [s.name for s in ptrace.spans] \
            == [s.name for s in jtrace.spans]
    assert stream_lines(pqs.metrics.render()) \
        == stream_lines(jqs.metrics.render())
    assert 'pio_stream_applies_total 3' in pqs.metrics.render()
    jqs.close()
    pqs.close()


# -- the command line ----------------------------------------------------------


def test_deploy_flags_reach_the_server_config(tmp_path):
    args = cli._parser().parse_args([
        "deploy", "--no-trace", "--trace-ring", "16", "--trace-slow-ms",
        "2.5", "--access-log-sample", "0.25", "--profile-dir",
        str(tmp_path), "--hot-keys-k", "0"])
    assert (args.no_trace, args.trace_ring, args.trace_slow_ms,
            args.access_log_sample, args.profile_dir, args.hot_keys_k) \
        == (True, 16, 2.5, 0.25, str(tmp_path), 0)
    args = cli._parser().parse_args(["eventserver", "--stats"])
    assert args.stats


def test_cli_trace_reads_a_running_server(factors, tmp_path, capsys):
    qs = port_server(factors, trace_slow_ms=1e-6)
    srv = es.create_engine_server(qs, "127.0.0.1", 0).start_background()
    try:
        _, _, headers = call(srv.port, "POST", "/queries.json",
                             {"user": "u1", "num": 2})
        tid = parse_traceparent(headers["traceparent"])[0]
        port = str(srv.port)
        assert cli.main(["trace", "--port", port]) == 0
        assert "flight recorder: 1/512 retained" in capsys.readouterr().out
        assert cli.main(["trace", "--port", port, "--slowest", "3"]) == 0
        assert tid in capsys.readouterr().out
        out = tmp_path / "t.json"
        assert cli.main(["trace", "--port", port, "--id", tid, "-o",
                         str(out)]) == 0
        assert json.loads(out.read_text())["otherData"]["traceId"] == tid
        assert cli.main(["trace", "--port", port, "--id", "nope"]) == 1
    finally:
        srv.close()
