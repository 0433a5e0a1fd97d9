"""The feedback loop, the remote log and deploy's retrain of an ephemeral
model, held to the JAX package on the same inputs.

Both packages share one SQLite ``PIO_HOME``: the JAX package trains the
instance and both deploy it (the port reads the JAX-written blob), so
their answers come from the same factors. The port serves on the CPU.
Every feedback event is read back from the store: a ``predict`` on
entity type ``pio_pr`` whose id is the answer's ``prId`` and whose
properties hold the instance id, the query and the answer without
``prId``. Scores are compared at rtol 1e-5 (f32 on both sides).
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

import predictionio_tpu.controller as jctl
import predictionio_tpu.models.als as jals
from predictionio_tpu.cli import build_parser as jax_parser
from predictionio_tpu.controller import Context as JContext
from predictionio_tpu.data import DataMap as JDataMap
from predictionio_tpu.data import Event as JEvent
from predictionio_tpu.data.storage import App as JApp
from predictionio_tpu.data.storage import Storage as JStorage
from predictionio_tpu.server import engineserver as jes
from predictionio_tpu.templates import recommendation as jrec
from predictionio_tpu.workflow import run_train as jax_run_train
import predictionio_tpu_torch.controller as pctl
from predictionio_tpu_torch import cli
from predictionio_tpu_torch import faults
from predictionio_tpu_torch.controller.context import Context
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.models.convert import als_model_from_numpy
from predictionio_tpu_torch.server import engineserver as es
from predictionio_tpu_torch.server.http import AppServer, HTTPApp, json_response
from predictionio_tpu_torch.templates import recommendation as prec
from predictionio_tpu_torch.workflow import core as pwf

APP, FEEDBACK_APP = "fbapp", "fbfeedback"
ENGINE_ID, VERSION, VARIANT = "fb", "1", "engine.json"
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
QUERIES = [{"user": "u1", "num": 3}, {"user": "u5", "num": 5},
           {"user": "u9", "num": 2, "blackList": ["i3"]},
           {"user": "stranger", "num": 4}]
PATHS = {"single": {},
         "serial": {"batching": True, "serving_pipeline": "serial"},
         "staged": {"batching": True, "serving_pipeline": "staged"}}


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setattr(jals, "HOST_SERVE_WORK", 0)


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    """A SQLite ``PIO_HOME`` with the ratings app, the feedback app and
    one COMPLETED instance the JAX package trained."""
    d = tmp_path_factory.mktemp("pio")
    st = JStorage(env={"PIO_HOME": str(d)})
    app_id = st.apps().insert(JApp(0, APP))
    st.apps().insert(JApp(0, FEEDBACK_APP))
    es_ = st.events()
    es_.init(app_id)
    rng = np.random.default_rng(7)
    events, t = [], T0
    for u in range(20):
        for i in rng.choice(20, size=6, replace=False):
            events.append(JEvent(
                event="rate", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{i}",
                properties=JDataMap({"rating": float(rng.integers(1, 6))}),
                event_time=t))
            t += timedelta(seconds=30)
    es_.insert_batch(events, app_id)
    ctx = JContext(app_name=APP, _storage=st)
    jax_run_train(ctx, jrec.recommendation_engine(), jax_params(), ENGINE_ID,
                  VERSION, VARIANT)
    return str(d)


def jax_params():
    return jrec.default_engine_params(APP, rank=4, num_iterations=4, seed=3)


def port_params():
    return prec.default_engine_params(APP, rank=4, num_iterations=4, seed=3)


def jax_deploy(home, **cfg):
    """The JAX package's engine server on the instance, serving; its
    ``QueryServer`` rides along as ``query_server`` (the port's name)."""
    from predictionio_tpu.workflow import (
        get_latest_completed,
        load_models_for_deploy,
    )

    ctx = JContext(_storage=JStorage(env={"PIO_HOME": home}))
    engine, ep = jrec.recommendation_engine(), jax_params()
    inst = get_latest_completed(ctx, ENGINE_ID, VERSION, VARIANT)
    models = load_models_for_deploy(ctx, engine, inst, ep)
    qs = jes.QueryServer(ctx, engine, ep, models, inst,
                         jes.ServerConfig(**cfg))
    srv = jes.create_engine_server(qs, "127.0.0.1", 0)
    srv.query_server = qs
    return srv.start_background()


def port_storage(home):
    return Storage(env={"PIO_HOME": home})


def port_deploy(home, **cfg):
    ctx = Context(device="cpu", _storage=port_storage(home))
    return es.deploy(ctx, prec.recommendation_engine(), port_params(),
                     ENGINE_ID, VERSION, VARIANT,
                     config=es.ServerConfig(device="cpu", **cfg),
                     host="127.0.0.1", port=0).start_background()


def stop(srv):
    (srv.close if hasattr(srv, "close") else srv.shutdown)()


def post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def predict_events(home):
    st = port_storage(home)
    app = st.apps().get_by_name(FEEDBACK_APP)
    return {e.entity_id: e for e in st.events().find(app.id)
            if e.event == "predict"}


def instance_id(home):
    st = port_storage(home)
    return pwf.get_latest_completed(Context(device="cpu", _storage=st),
                                    ENGINE_ID, VERSION, VARIANT).id


def assert_feedback(answer, query, events, iid):
    pr_id = answer["prId"]
    assert len(pr_id) == 64 and int(pr_id, 16) >= 0
    ev = events[pr_id]
    assert (ev.event, ev.entity_type) == ("predict", "pio_pr")
    props = ev.properties.to_dict()
    assert set(props) == {"engineInstanceId", "query", "prediction"}
    assert props["engineInstanceId"] == iid
    assert props["query"] == query
    assert props["prediction"] == {k: v for k, v in answer.items()
                                   if k != "prId"}


def item_scores(answer):
    return ([s["item"] for s in answer["itemScores"]],
            np.array([s["score"] for s in answer["itemScores"]]))


@pytest.mark.parametrize("path", list(PATHS))
def test_feedback_event_and_prid_match_jax(home, path):
    iid = instance_id(home)
    answers = {}
    for name, deploy in (("jax", jax_deploy), ("port", port_deploy)):
        srv = deploy(home, feedback=True, feedback_app_name=FEEDBACK_APP,
                     **PATHS[path])
        try:
            answers[name] = [post(srv.port, "/queries.json", q)
                             for q in QUERIES]
            if name == "port":
                phases = srv.query_server.phase_seconds
        finally:
            stop(srv)
    events = predict_events(home)
    for q, (js, ja), (ps, pa) in zip(QUERIES, answers["jax"],
                                     answers["port"]):
        assert js == ps == 200
        assert_feedback(ja, q, events, iid)
        assert_feedback(pa, q, events, iid)
        assert ja["prId"] != pa["prId"]
        jids, jscores = item_scores(ja)
        pids, pscores = item_scores(pa)
        assert pids == jids
        np.testing.assert_allclose(pscores, jscores, rtol=1e-5)
    assert phases["feedback"] > 0


def test_the_feedback_app_is_checked_at_bind(home):
    for cfg in ({"feedback": True},
                {"feedback": True, "feedback_app_name": "nope"}):
        with pytest.raises(ValueError, match="feedback"):
            jax_deploy(home, **cfg)
        with pytest.raises(ValueError, match="feedback"):
            port_deploy(home, **cfg)


def test_a_failed_feedback_insert_never_fails_the_query(home, monkeypatch):
    srv = port_deploy(home, feedback=True, feedback_app_name=FEEDBACK_APP)
    try:
        qs = srv.query_server

        def refuse(*a, **k):
            raise RuntimeError("store down")

        monkeypatch.setattr(qs.ctx.storage, "events",
                            lambda: type("E", (), {"insert": refuse})())
        status, body = post(srv.port, "/queries.json", QUERIES[0])
        assert status == 200 and len(body["prId"]) == 64
    finally:
        stop(srv)


class Collector:
    """A log sink on its own port: every POST body, in order."""

    def __init__(self):
        self.received = []
        app = HTTPApp("collector")

        @app.route("POST", "/log")
        def sink(req):
            self.received.append(req.body.decode())
            return json_response({"ok": True})

        self.server = AppServer(app, "127.0.0.1", 0).start_background()
        self.url = f"http://127.0.0.1:{self.server.port}/log"

    def messages(self, prefix):
        assert all(r.startswith(prefix) for r in self.received)
        return [json.loads(r[len(prefix):]) for r in self.received]


def test_remote_log_ships_and_swallows_as_jax(home):
    collector = Collector()
    iid = instance_id(home)
    cfg = {"log_url": collector.url, "log_prefix": "PIO: "}
    try:
        for deploy in (jax_deploy, port_deploy):
            srv = deploy(home, **cfg)
            try:
                # a client error ships nothing
                assert post(srv.port, "/queries.json", {"bogus": 1})[0] \
                    == 400
                srv.query_server.remote_log("boom", wait=True)
            finally:
                stop(srv)
        assert collector.messages("PIO: ") == [
            {"engineInstance": iid, "message": "boom"}] * 2
    finally:
        collector.server.close()
    srv = port_deploy(home, **cfg)
    try:
        srv.query_server.remote_log("after-shutdown", wait=True)  # no raise
        srv.query_server.remote_log("after-shutdown")
    finally:
        stop(srv)


@pytest.mark.parametrize("pipeline", ["serial", "staged"])
def test_a_failed_batch_ships_once(home, pipeline):
    """An injected dispatch error fails one batch: its queries answer
    500 and the collector receives exactly one message for it, which
    the route does not ship again."""
    collector = Collector()
    srv = port_deploy(home, batching=True, serving_pipeline=pipeline,
                      batch_window_ms=50.0, log_url=collector.url,
                      log_prefix="PIO: ")
    try:
        srv.query_server.warm_done.wait(30)
        faults.inject_spec("serving.dispatch=error,times=1")
        out = [None] * 3

        def ask(i):
            out[i] = post(srv.port, "/queries.json", QUERIES[i])

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        failed = [b for s, b in out if s == 500]
        assert failed and all(s in (200, 500) for s, _ in out)
        srv.close()  # joins the shipping threads
        msgs = collector.messages("PIO: ")
        assert len(msgs) == (1 if pipeline == "serial" else len(failed))
        assert all(m["engineInstance"] == instance_id(home) for m in msgs)
    finally:
        faults.clear()
        stop(srv)
        collector.server.close()


def test_close_joins_a_remote_log_thread_on_a_hung_collector(monkeypatch):
    """A collector that accepts and never answers: the shipping thread
    ends at the urlopen timeout, and ``close()`` waits for it."""
    monkeypatch.setattr(es, "REMOTE_LOG_TIMEOUT_SEC", 0.5)
    hung = socket.socket()
    hung.bind(("127.0.0.1", 0))
    hung.listen(8)
    rng = np.random.default_rng(3)
    model = als_model_from_numpy(
        rng.normal(size=(4, 4)).astype(np.float32),
        rng.normal(size=(6, 4)).astype(np.float32), 4, 6,
        {f"u{i}": i for i in range(4)}, {f"i{i}": i for i in range(6)},
        {"rank": 4}, device="cpu")
    engine = prec.recommendation_engine()
    ep = engine.params_from_variant(
        {"algorithms": [{"name": "als", "params": {"rank": 4}}]})
    srv = es.deploy_models(
        engine, ep, [model],
        es.ServerConfig(device="cpu", warm_start=False,
                        log_url=f"http://127.0.0.1:{hung.getsockname()[1]}"),
        "127.0.0.1", 0).start_background()
    try:
        srv.query_server.remote_log("into the void")
        assert any(t.name == "remote-log" for t in threading.enumerate())
        t0 = time.monotonic()
        srv.close()
        assert time.monotonic() - t0 < es.REMOTE_LOG_TIMEOUT_SEC + 5
        assert not any(t.name == "remote-log" and t.is_alive()
                       for t in threading.enumerate())
    finally:
        hung.close()


def test_the_stream_app_falls_back_to_the_feedback_app(home):
    apps = {}
    for name, deploy in (("jax", jax_deploy), ("port", port_deploy)):
        srv = deploy(home, feedback=True, feedback_app_name=FEEDBACK_APP,
                     stream_interval_ms=60_000.0)
        try:
            trainer = srv.query_server.start_stream()
            apps[name] = trainer.config.app_name
            srv.query_server.stop_stream()
            status, _ = post(srv.port, "/stream/start", {})
            assert status == 200
            apps[name + "-route"] = srv.query_server.stream.config.app_name
            srv.query_server.stop_stream()
        finally:
            stop(srv)
    assert set(apps.values()) == {FEEDBACK_APP}


FLAGS = ["--feedback", "--feedback-app-name", FEEDBACK_APP,
         "--batch-window-ms", "7.5"]


@pytest.mark.parametrize("flags", [FLAGS, []], ids=["set", "defaults"])
def test_deploy_flags_parse_into_the_server_config(home, flags, tmp_path,
                                                   monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / VARIANT).write_text(json.dumps({
        "id": ENGINE_ID, "version": VERSION,
        "engineFactory":
            "predictionio_tpu.templates.recommendation:recommendation_engine",
        "datasource": {"params": {"app_name": APP}},
        "algorithms": [{"name": "als", "params": {
            "rank": 4, "num_iterations": 4, "seed": 3}}]}))
    common = ["deploy", "--engine-json", VARIANT, "--ip", "127.0.0.1",
              "--port", "0"]
    jargs = jax_parser().parse_args(common + flags)
    pargs = cli._parser().parse_args(common + ["--device", "cpu"] + flags)
    for knob in ("feedback", "feedback_app_name", "batch_window_ms"):
        assert getattr(pargs, knob) == getattr(jargs, knob), knob
    if not flags:
        return
    srv = cli.build_deploy(pargs, port_storage(home))
    try:
        cfg = srv.query_server.config
        assert (cfg.feedback, cfg.feedback_app_name, cfg.batch_window_ms) \
            == (True, FEEDBACK_APP, 7.5)
    finally:
        srv.close()


# -- deploy retrains an ephemeral model -----------------------------------------


def fixture_engine(ctl, calls):
    """A two-algorithm engine of ``ctl``'s classes: "kept" persists its
    model, "ephemeral" persists None (the reference's Unit model)."""

    class DS(ctl.DataSource):
        def __init__(self, params=None):
            pass

        def read_training(self, ctx):
            calls["read"] += 1
            return 7

    class Kept(ctl.Algorithm):
        def __init__(self, params=None):
            pass

        def train(self, ctx, pd):
            calls["train"] += 1
            return ("model", pd, calls["train"])

        def predict(self, model, query):
            return model

    class Ephemeral(Kept):
        def make_persistent_model(self, model, iid, ax):
            return None

    class Serve(ctl.Serving):
        def __init__(self, params=None):
            pass

        def serve(self, query, predictions):
            return predictions

    return ctl.Engine(
        datasource_classes=DS, preparator_classes=ctl.IdentityPreparator,
        algorithm_classes={"kept": Kept, "ephemeral": Ephemeral},
        serving_classes=Serve)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_prepare_deploy_retrains_a_none_model_and_loads_the_rest(pkg):
    ctl, ctx = ((jctl, JContext()) if pkg == "jax"
                else (pctl, Context(device="cpu")))
    calls = {"read": 0, "train": 0}
    engine = fixture_engine(ctl, calls)
    ep = ctl.EngineParams(algorithms=(("kept", None), ("ephemeral", None)))
    trained = engine.train(ctx, ep).models
    algos = engine.make_algorithms(ep)
    stored = [a.make_persistent_model(m, "iid", i)
              for i, (a, m) in enumerate(zip(algos, trained))]
    assert stored[1] is None and stored[0] == trained[0]
    before = dict(calls)
    models = engine.prepare_deploy(ctx, ep, stored, "iid")
    assert calls == {"read": before["read"] + 1,
                     "train": before["train"] + 2}
    assert models[0] == stored[0]           # loaded, not retrained
    assert models[1] == ("model", 7, 4)     # the retrain's model
    with pytest.raises(ValueError, match="stored models"):
        engine.prepare_deploy(ctx, ep, stored[:1], "iid")


class EphemeralALS(prec.ALSAlgorithm):
    """The recommendation template's ALS, persisting nothing."""

    def make_persistent_model(self, model, iid, ax):
        return None


def test_deploy_retrains_an_ephemeral_als_model(home):
    """A stored None deploys as a fresh training on the context's device:
    factors bitwise a direct ``Engine.train`` with the same params, and
    the answers from them."""
    st = Storage(env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
    src = port_storage(home)
    app = src.apps().get_by_name(APP)
    app_id = st.apps().insert(type(app)(0, APP))
    st.events().init(app_id)
    st.events().insert_batch(list(src.events().find(app.id)), app_id)
    engine = prec.recommendation_engine()
    engine.algorithm_classes["als"] = EphemeralALS
    ctx = Context(device="cpu", _storage=st)
    ep = port_params()
    pwf.run_train(ctx, engine, ep, ENGINE_ID, VERSION, VARIANT)
    want = engine.train(ctx, ep).models[0]
    srv = es.deploy(ctx, engine, ep, ENGINE_ID, VERSION, VARIANT,
                    config=es.ServerConfig(device="cpu"), host="127.0.0.1",
                    port=0).start_background()
    try:
        got = srv.query_server.models[0]
        assert got is not None
        assert np.array_equal(got.user_factors.numpy(),
                              want.user_factors.numpy())
        assert np.array_equal(got.item_factors.numpy(),
                              want.item_factors.numpy())
        status, body = post(srv.port, "/queries.json", QUERIES[0])
        assert status == 200 and len(body["itemScores"]) == 3
    finally:
        srv.close()
