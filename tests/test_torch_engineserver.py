"""The port's engine server against the JAX package's ALSAlgorithm.predict.

The port serves on the CPU (``device="cpu"``, ``port=0``); every HTTP
answer is compared with the JAX template's ``predict`` on the same model
(f32: same items, scores rtol 1e-5; int8: scores rtol 1e-4, the seed
leaves no near-tie at the cut). The JAX side takes its device path
(``HOST_SERVE_WORK = 0``, test-side only).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import predictionio_tpu.models.als as jals
from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.templates.recommendation import (
    ALSAlgorithm as JaxALSAlgorithm,
)
from predictionio_tpu.templates.recommendation import Query as JaxQuery
from predictionio_tpu_torch import cli
from predictionio_tpu_torch.models.convert import als_model_from_numpy
from predictionio_tpu_torch.server import engineserver as es
from predictionio_tpu_torch.server.engineserver import ServerConfig, deploy_models
from predictionio_tpu_torch.templates.recommendation import (
    recommendation_engine,
)
from predictionio_tpu_torch.workflow.persistence import dumps_models

N_USERS, N_ITEMS, RANK = 40, 120, 8
VARIANT = {"id": "default",
           "algorithms": [{"name": "als",
                           "params": {"rank": RANK, "lambda": 0.01}}]}

QUERIES = [
    {"user": "u3", "num": 4},
    {"user": "u7", "num": 10, "blackList": ["i5", "i9", "nope"]},
    {"user": "u0", "num": 1},
    {"user": "u39", "num": 25},
    {"user": "stranger", "num": 5},
]


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setattr(jals, "HOST_SERVE_WORK", 0)


@pytest.fixture(scope="module")
def factors():
    rng = np.random.default_rng(21)
    return (rng.normal(size=(N_USERS, RANK)).astype(np.float32),
            rng.normal(size=(N_ITEMS, RANK)).astype(np.float32))


def ids(prefix, n):
    return {f"{prefix}{i}": i for i in range(n)}


@pytest.fixture(scope="module")
def jax_model(factors):
    U, V = factors
    return jals.ALSModel(
        user_factors=U, item_factors=V, n_users=N_USERS, n_items=N_ITEMS,
        user_ids=JaxBiMap(ids("u", N_USERS)),
        item_ids=JaxBiMap(ids("i", N_ITEMS)),
        params=jals.ALSParams(rank=RANK))


def port_model(factors):
    U, V = factors
    return als_model_from_numpy(U, V, N_USERS, N_ITEMS, ids("u", N_USERS),
                                ids("i", N_ITEMS), {"rank": RANK},
                                device="cpu")


def start(factors, **cfg):
    engine = recommendation_engine()
    ep = engine.params_from_variant(VARIANT)
    srv = deploy_models(engine, ep, [port_model(factors)],
                 ServerConfig(device="cpu", **cfg), "127.0.0.1", 0)
    return srv.start_background()


#: loopback only: no proxy from the environment may carry these requests
LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def post(srv, path, body, raw=False):
    data = body if raw else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=data, method="POST",
        headers={"Content-Type": "application/json"})
    with LOCAL.open(req, timeout=30) as resp:
        return json.loads(resp.read())


def get(srv, path):
    with LOCAL.open(f"http://127.0.0.1:{srv.port}{path}",
                    timeout=30) as resp:
        return json.loads(resp.read())


def jax_answer(model, q):
    algo = JaxALSAlgorithm(jals.ALSParams(rank=RANK))
    return algo.predict(model, JaxQuery(
        user=q["user"], num=q["num"],
        black_list=q.get("blackList"))).to_json()


def assert_same(got, want, rtol):
    assert [s["item"] for s in got["itemScores"]] \
        == [s["item"] for s in want["itemScores"]]
    np.testing.assert_allclose([s["score"] for s in got["itemScores"]],
                               [s["score"] for s in want["itemScores"]],
                               rtol=rtol, atol=rtol)


def wait_threads(limit, timeout=10.0):
    deadline = time.monotonic() + timeout
    while threading.active_count() > limit and time.monotonic() < deadline:
        time.sleep(0.05)
    return threading.active_count()


@pytest.mark.parametrize("batching", [False, True])
def test_queries_match_jax_predict(factors, jax_model, batching):
    srv = start(factors, batching=batching)
    try:
        for q in QUERIES:
            assert_same(post(srv, "/queries.json", q),
                        jax_answer(jax_model, q), 1e-5)
        assert post(srv, "/queries.json",
                    {"user": "stranger"}) == {"itemScores": []}
    finally:
        srv.close()


def test_concurrent_queries_coalesce(factors, jax_model):
    srv = start(factors, batching=True, batch_window_ms=50.0)
    qs = srv.query_server
    sizes = []
    # the batched launch: where both batch paths pass
    algo = qs.algorithms[0]
    inner = algo.batch_predict_async

    def spy(model, batch):
        sizes.append(len(batch))
        return inner(model, batch)

    algo.batch_predict_async = spy
    queries = [{"user": f"u{i}", "num": 5 + i % 4} for i in range(16)]
    answers = [None] * 16
    gate = threading.Barrier(16)

    def client(i):
        gate.wait(timeout=10)
        answers[i] = post(srv, "/queries.json", queries[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        for q, a in zip(queries, answers):
            assert_same(a, jax_answer(jax_model, q), 1e-5)
        assert sum(sizes) == 16 and max(sizes) > 1
    finally:
        srv.close()


def test_status_and_bad_query(factors):
    srv = start(factors, serving_quant="int8")
    try:
        st = get(srv, "/status.json")
        assert st["device"] == "cpu" and st["card"] == "cpu"
        assert st["servingQuant"] == "int8"
        assert st["kernels"]["fused_topk"]["launches"] >= 0
        with pytest.raises(urllib.error.HTTPError) as e:
            post(srv, "/queries.json", {"usr": "u1"})
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            post(srv, "/queries.json", b"{not json", raw=True)
        assert e.value.code == 400
    finally:
        srv.close()


def start_with_shadow_rollout(factors):
    """A storage-backed deploy of one release with a shadow rollout of a
    second live: its gate thread running and every query mirrored."""
    from datetime import datetime, timezone

    from predictionio_tpu_torch.controller.context import Context
    from predictionio_tpu_torch.data.storage.base import (
        STATUS_COMPLETED,
        EngineInstance,
        Model,
    )
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.rollout import HealthPolicy

    storage = Storage(env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
    for n, iid in enumerate(("r1", "r2")):
        t = datetime(2026, 1, 1, 0, n, tzinfo=timezone.utc)
        storage.engine_instances().insert(EngineInstance(
            id=iid, status=STATUS_COMPLETED, start_time=t, end_time=t,
            engine_id="default", engine_version="1",
            engine_variant="engine.json", engine_factory="f"))
        storage.models().insert(Model(iid, dumps_models(
            [port_model(factors)])))
    engine = recommendation_engine()
    srv = es.deploy(Context(device="cpu", _storage=storage), engine,
                    engine.params_from_variant(VARIANT),
                    config=ServerConfig(device="cpu", batching=True),
                    host="127.0.0.1", port=0).start_background()
    srv.query_server.start_canary(
        "r1", shadow=True, policy=HealthPolicy(window_sec=0.05))
    return srv


@pytest.mark.parametrize("how", ["stop", "close", "close-shadow-rollout"])
def test_shutdown_leaves_no_threads(factors, how):
    base = wait_threads(threading.active_count())
    if how == "close-shadow-rollout":
        srv = start_with_shadow_rollout(factors)
        for u in range(8):
            post(srv, "/queries.json", {"user": f"u{u}", "num": 3})
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                srv.query_server.rollout.windows < 2:
            time.sleep(0.02)
        names = {t.name.split("_")[0] for t in threading.enumerate()}
        assert {"rollout-controller", "shadow-mirror"} <= names
    else:
        srv = start(factors, batching=True)
    post(srv, "/queries.json", {"user": "u1", "num": 3})
    assert threading.active_count() > base  # drainers and listener live
    if how == "stop":
        assert post(srv, "/stop", {}) == {"message": "Shutting down..."}
    else:
        srv.close()
    assert wait_threads(base) <= base
    if how == "stop":
        with pytest.raises(urllib.error.URLError):
            post(srv, "/queries.json", {"user": "u1"})


def test_default_device_is_the_card(factors, monkeypatch):
    """No CPU default: without CUDA, a deploy that names no device fails."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    engine = recommendation_engine()
    with pytest.raises(RuntimeError, match="CUDA"):
        deploy_models(engine, engine.params_from_variant(VARIANT),
                      [port_model(factors)], ServerConfig(), "127.0.0.1", 0)


def test_cli_deploy_of_a_persisted_model(factors, jax_model, tmp_path):
    (tmp_path / "engine.json").write_text(json.dumps(VARIANT))
    (tmp_path / "model.npz").write_bytes(dumps_models([port_model(factors)]))
    args = cli._parser().parse_args([
        "deploy", "--engine-json", str(tmp_path / "engine.json"),
        "--model", str(tmp_path / "model.npz"), "--ip", "127.0.0.1",
        "--port", "0", "--device", "cpu", "--serving-quant", "int8",
        "--batching"])
    srv = cli.build_deploy(args).start_background()
    jq = jals.quantize_serving_model(jax_model, "int8")
    assert jals.table_quant(jq.item_factors) == "int8"
    try:
        assert get(srv, "/status.json")["servingQuant"] == "int8"
        for q in QUERIES:
            assert_same(post(srv, "/queries.json", q), jax_answer(jq, q),
                        1e-4)
    finally:
        srv.close()


@pytest.mark.parametrize("pipeline", ["serial", "staged"])
def test_close_serves_queued_queries_first(factors, pipeline):
    """The batch path's close(): work queued ahead of the close sentinels
    still serves, no caller is stranded, and every thread exits. The
    queries are held in the bound serving's ``serve``, which both paths
    pass, until close() has begun."""
    base = wait_threads(threading.active_count())
    srv = start(factors, batching=True, batch_window_ms=0.0,
                serving_pipeline=pipeline)
    qs = srv.query_server
    release = threading.Event()
    inner = qs.serving.serve
    taken = []

    def held(query, predictions):
        taken.append(query)
        release.wait(timeout=10)
        return inner(query, predictions)

    qs.serving.serve = held
    submitted = []
    put = qs.batcher._q.put

    def counting_put(item, *args, **kwargs):
        if item is not es._CLOSE:
            submitted.append(item)
        return put(item, *args, **kwargs)

    qs.batcher._q.put = counting_put
    answers = []
    callers = [threading.Thread(target=lambda i=i: answers.append(
        qs.serve({"user": f"u{i}", "num": 3}))) for i in range(5)]
    for t in callers:
        t.start()
    deadline = time.monotonic() + 10
    while (len(submitted) < 5 or not taken) \
            and time.monotonic() < deadline:
        time.sleep(0.01)  # every query submitted, one held in serve
    assert len(submitted) == 5 and taken
    closer = threading.Thread(target=qs.close)
    closer.start()
    release.set()
    for t in callers + [closer]:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in callers + [closer])
    assert len(answers) == 5
    assert all(len(a["itemScores"]) == 3 for a in answers)
    assert not any(t.is_alive() for t in qs.batcher._threads)
    srv.close()
    assert wait_threads(base) <= base
