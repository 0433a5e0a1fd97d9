"""The port's batch paths (the staged pipeline and the serial drainers)
against the JAX package's, and their behaviour, mirroring
``tests/test_pipeline.py``.

A 64-user x 40-item model at rank 8 (factors from a numpy seed) is bound
in both packages with ``batching=True``; the same queries (some with
blacklists, some for unknown users) go through both ``batcher.submit``s
concurrently. Ids match exactly; scores within rel 1e-5 on f32 tables
and 1e-4 on int8 ones (the seed leaves no near-tie at any cut). The JAX
side runs on the CPU through its device path (``HOST_SERVE_WORK = 0``,
test-side only) with ``warm_start=False``; the port on ``device="cpu"``.
"""

import argparse
import inspect
import json
import queue
import threading
import time
import urllib.request
from datetime import datetime, timezone

import numpy as np
import pytest

import predictionio_tpu.models.als as jals
from predictionio_tpu.cli import build_parser as jax_cli_parser
from predictionio_tpu.controller import Context as JContext
from predictionio_tpu.data.bimap import BiMap as JBiMap
from predictionio_tpu.data.storage import App as JApp
from predictionio_tpu.data.storage import Storage as JStorage
from predictionio_tpu.data.storage.base import STATUS_COMPLETED as J_DONE
from predictionio_tpu.data.storage.base import EngineInstance as JInstance
from predictionio_tpu.obs import OverlapTracker as JaxOverlapTracker
from predictionio_tpu.server import engineserver as jes
from predictionio_tpu.templates.recommendation import (
    default_engine_params as jax_engine_params,
)
from predictionio_tpu.templates.recommendation import (
    recommendation_engine as jax_engine,
)
from predictionio_tpu_torch import cli
from predictionio_tpu_torch.controller.base import FirstServing
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.models.convert import als_model_from_numpy
from predictionio_tpu_torch.obs import OverlapTracker
from predictionio_tpu_torch.server import engineserver as es
from predictionio_tpu_torch.server.engineserver import (
    HTTPError,
    MicroBatcher,
    QueryServer,
    ServerConfig,
    StagedPipeline,
)
from predictionio_tpu_torch.templates.recommendation import (
    recommendation_engine,
)
from predictionio_tpu_torch.workflow.persistence import dumps_models

N_USERS, N_ITEMS, RANK = 64, 40, 8
MODES = ("staged", "serial")
RTOL = {"off": 1e-5, "int8": 1e-4}
VARIANT = {"algorithms": [{"name": "als", "params": {"rank": RANK}}]}

QUERIES = [
    {"user": "u3", "num": 4},
    {"user": "u7", "num": 10, "blackList": ["i5", "i9", "nope"]},
    {"user": "u0", "num": 1},
    {"user": "u63", "num": 25},
    {"user": "stranger", "num": 5},
    {"user": "u12", "num": 40, "blackList": ["i1"]},
    {"user": "u40", "num": 3},
    {"user": "ghost", "num": 2, "blackList": ["i2"]},
]

#: loopback only: no proxy from the environment may carry these requests
LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setattr(jals, "HOST_SERVE_WORK", 0)


@pytest.fixture(scope="module")
def factors():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((N_USERS, RANK)).astype(np.float32),
            rng.standard_normal((N_ITEMS, RANK)).astype(np.float32))


def ids(prefix, n):
    return {f"{prefix}{i}": i for i in range(n)}


def port_model(factors, scale=1.0):
    U, V = factors
    return als_model_from_numpy(U, V * scale, N_USERS, N_ITEMS,
                                ids("u", N_USERS), ids("i", N_ITEMS),
                                {"rank": RANK}, device="cpu")


@pytest.fixture()
def closing():
    """Close every server a test opens (both packages), even on failure."""
    opened = []
    yield lambda qs: opened.append(qs) or qs
    for qs in opened:
        qs.close()


def jax_server(factors, **cfg):
    U, V = factors
    model = jals.ALSModel(
        user_factors=U, item_factors=V, n_users=N_USERS, n_items=N_ITEMS,
        user_ids=JBiMap(ids("u", N_USERS)),
        item_ids=JBiMap(ids("i", N_ITEMS)),
        params=jals.ALSParams(rank=RANK))
    storage = JStorage(env={"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})
    storage.apps().insert(JApp(0, "pipe"))
    now = datetime.now(timezone.utc)
    inst = JInstance(
        id="p0", status=J_DONE, start_time=now, end_time=now,
        engine_id="pipe", engine_version="1", engine_variant="engine.json",
        engine_factory="synthetic")
    storage.engine_instances().insert(inst)
    return jes.QueryServer(
        JContext(app_name="pipe", _storage=storage), jax_engine(),
        jax_engine_params("pipe", rank=RANK), [model], inst,
        jes.ServerConfig(warm_start=False, **cfg))


def port_server(factors, **cfg):
    engine = recommendation_engine()
    return QueryServer(engine, engine.params_from_variant(VARIANT),
                       [port_model(factors)],
                       ServerConfig(device="cpu", **cfg))


def burst(qs, queries):
    """Every query submitted at once from its own thread; answers in
    query order."""
    out = [None] * len(queries)
    gate = threading.Barrier(len(queries))

    def fire(i):
        gate.wait(timeout=10)
        out[i] = qs.batcher.submit(queries[i])

    threads = [threading.Thread(target=fire, args=(i,))
               for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    return out


def assert_same(got, want, rtol):
    assert not isinstance(got, Exception), got
    assert [s["item"] for s in got["itemScores"]] \
        == [s["item"] for s in want["itemScores"]]
    np.testing.assert_allclose([s["score"] for s in got["itemScores"]],
                               [s["score"] for s in want["itemScores"]],
                               rtol=rtol, atol=rtol)


# -- against the JAX package -------------------------------------------------

@pytest.mark.parametrize("quant", ["off", "int8"])
@pytest.mark.parametrize("mode", MODES)
def test_both_packages_answer_alike(factors, closing, mode, quant):
    cfg = dict(batching=True, serving_pipeline=mode, serving_quant=quant,
               max_batch=8, batch_window_ms=20.0)
    jqs = closing(jax_server(factors, **cfg))
    pqs = closing(port_server(factors, **cfg))
    queries = QUERIES * 3
    want = burst(jqs, queries)
    got = burst(pqs, queries)
    for q, g, w in zip(queries, got, want):
        assert_same(g, w, RTOL[quant])
        if q["user"] in ("stranger", "ghost"):
            assert g == {"itemScores": []}
    assert pqs.pipeline_status()["mode"] == mode
    assert pqs.queries_batched == len(queries)


@pytest.mark.parametrize("mode", MODES)
def test_pipeline_status_has_the_jax_keys(factors, closing, mode):
    cfg = dict(batching=True, serving_pipeline=mode)
    jqs = closing(jax_server(factors, **cfg))
    pqs = closing(port_server(factors, **cfg))
    burst(jqs, QUERIES)
    burst(pqs, QUERIES)
    j, p = jqs.pipeline_status(), pqs.pipeline_status()
    # the JAX package's serial drainers record no overlap; the port's do
    assert set(p) - {"overlap"} == set(j) - {"overlap"}
    assert "overlap" in p
    if "overlap" in j:
        assert set(p["overlap"]) == set(j["overlap"])
    for key in ("mode", "deadlineMs", "deadlineExceeded", "depth",
                "assembleWorkers", "readbackWorkers"):
        assert p.get(key) == j.get(key), key
    assert 0.0 <= p["overlap"]["deviceIdleFraction"] <= 1.0
    assert 0.0 <= p["overlap"]["overlapFraction"] <= 1.0


def overlap_script(seed=0, steps=60):
    """A random sequence of (time, op, track) transitions."""
    rng = np.random.default_rng(seed)
    t, active, out = 0.0, {}, []
    for _ in range(steps):
        t += float(rng.integers(0, 4)) * 0.25
        track = ("device", "assemble", "readback")[rng.integers(0, 3)]
        if active.get(track, 0) > 0 and rng.random() < 0.5:
            active[track] -= 1
            out.append((t, "exit", track))
        else:
            active[track] = active.get(track, 0) + 1
            out.append((t, "enter", track))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_overlap_tracker_matches_jax(seed):
    clock = [0.0]
    trackers = (OverlapTracker(time_fn=lambda: clock[0]),
                JaxOverlapTracker(time_fn=lambda: clock[0]))
    for t, op, track in overlap_script(seed):
        clock[0] = t
        got = [getattr(tr, op)(track) for tr in trackers]
        assert got[0] == got[1]
        if op == "enter":
            assert trackers[0].active(track) == trackers[1].active(track)
    clock[0] += 1.0
    assert trackers[0].snapshot() == trackers[1].snapshot()


def test_overlap_accounting():
    t = [0.0]
    tr = OverlapTracker(time_fn=lambda: t[0])
    tr.enter("device")
    t[0] = 1.0
    assert tr.enter("assemble") == 0
    t[0] = 3.0
    tr.exit("assemble")
    t[0] = 4.0
    tr.exit("device")
    t[0] = 5.0
    snap = tr.snapshot()
    assert snap["wall_sec"] == pytest.approx(5.0)
    assert snap["device_busy_sec"] == pytest.approx(4.0)
    assert snap["overlap_sec"] == pytest.approx(2.0)
    assert snap["device_idle_fraction"] == pytest.approx(0.2)
    assert snap["overlap_fraction"] == pytest.approx(0.4)


def test_overlap_enter_returns_prior_count_and_idles_without_traffic():
    tr = OverlapTracker()
    assert tr.device_idle_fraction() == 1.0
    assert tr.overlap_fraction() == 0.0
    assert tr.enter("device") == 0
    assert tr.enter("device") == 1
    tr.exit("device")
    tr.exit("device")
    assert tr.active("device") == 0


def test_cli_deploy_pipeline_flags_match_jax(factors, tmp_path):
    """The deploy command's pipeline flags: the JAX CLI's names and
    defaults, carried into the bound server's config."""
    def dests(parser):
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        return {a.dest: a.default
                for a in sub.choices["deploy"]._actions}

    flags = ("batch_pipeline", "pipeline", "queue_deadline_ms",
             "assemble_workers", "readback_workers", "pipeline_depth")
    port, jax = dests(cli._parser()), dests(jax_cli_parser())
    assert {f: port[f] for f in flags} == {f: jax[f] for f in flags}
    (tmp_path / "engine.json").write_text(json.dumps(VARIANT))
    (tmp_path / "model.npz").write_bytes(dumps_models([port_model(factors)]))
    base = ["deploy", "--engine-json", str(tmp_path / "engine.json"),
            "--model", str(tmp_path / "model.npz"), "--ip", "127.0.0.1",
            "--port", "0", "--device", "cpu", "--batching"]
    srv = cli.build_deploy(cli._parser().parse_args(base))
    try:
        assert isinstance(srv.query_server.batcher, StagedPipeline)
    finally:
        srv.close()
    srv = cli.build_deploy(cli._parser().parse_args(base + [
        "--pipeline", "serial", "--batch-pipeline", "3",
        "--queue-deadline-ms", "250", "--assemble-workers", "2",
        "--readback-workers", "5", "--pipeline-depth", "6"]))
    try:
        cfg = srv.query_server.config
        assert isinstance(srv.query_server.batcher, MicroBatcher)
        assert len(srv.query_server.batcher._threads) == 3
        assert (cfg.serving_pipeline, cfg.batch_pipeline,
                cfg.queue_deadline_ms, cfg.assemble_workers,
                cfg.readback_workers, cfg.pipeline_depth) \
            == ("serial", 3, 250.0, 2, 5, 6)
    finally:
        srv.close()


# -- behaviour -----------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_flood_4x_max_batch_no_lost_or_swapped_slots(factors, closing, mode):
    qs = closing(port_server(factors, batching=True, serving_pipeline=mode,
                             max_batch=8, batch_window_ms=5.0))
    want = {u: qs.query({"user": f"u{u}", "num": 3}) for u in range(8)}
    queries = [{"user": f"u{i % 8}", "num": 3} for i in range(32)]
    for i, r in enumerate(burst(qs, queries)):
        assert not isinstance(r, HTTPError), f"slot {i}: {r}"
        assert_same(r, want[i % 8], 1e-5)
    assert qs.queries_batched == 32


@pytest.mark.parametrize("mode", MODES)
def test_burst_batches_actually_coalesce(factors, closing, mode):
    qs = closing(port_server(factors, batching=True, serving_pipeline=mode,
                             max_batch=16, batch_window_ms=20.0))
    burst(qs, [{"user": f"u{i % 8}", "num": 3} for i in range(48)])
    assert qs.queries_batched == 48
    assert qs.batches_served < 48  # at least one real coalesced batch


@pytest.mark.parametrize("mode", MODES)
def test_parse_errors_complete_without_a_dispatch(factors, closing,
                                                  monkeypatch, mode):
    qs = closing(port_server(factors, batching=True, serving_pipeline=mode))
    algo = qs.algorithms[0]
    launched = []
    inner = algo.batch_predict_async

    def spy(model, queries):
        launched.append(len(queries))
        return inner(model, queries)

    monkeypatch.setattr(algo, "batch_predict_async", spy)
    r = qs.batcher.submit({"bogus": 1})
    assert isinstance(r, HTTPError) and r.status == 400
    assert launched == []
    assert qs.query_errors.get("400") == 1
    assert len(qs.batcher.submit({"user": "u1", "num": 2})["itemScores"]) \
        == 2
    assert launched == [1]


class Wedged:
    """A serving whose supplement blocks for ``seconds``."""

    def __init__(self, inner, seconds):
        self.inner = inner
        self.seconds = seconds

    def supplement(self, q):
        time.sleep(self.seconds)
        return self.inner.supplement(q)

    def serve(self, q, ps):
        return self.inner.serve(q, ps)


@pytest.mark.parametrize("mode", MODES)
def test_wedged_serve_sheds_503_at_the_deadline(factors, closing, mode):
    qs = closing(port_server(factors, batching=True, serving_pipeline=mode,
                             max_batch=4, queue_deadline_ms=150.0))
    qs.serving = Wedged(qs.serving, 1.0)
    t0 = time.monotonic()
    r = qs.batcher.submit({"user": "u1", "num": 2})
    waited = time.monotonic() - t0
    assert isinstance(r, HTTPError) and r.status == 503
    assert waited < 0.9  # at the deadline, not when the wedge cleared
    assert qs.deadline_exceeded >= 1
    assert qs.query_errors.get("503", 0) >= 1
    assert qs.pipeline_status()["deadlineExceeded"] >= 1


@pytest.mark.parametrize("mode", MODES)
def test_expired_queue_entries_are_shed_and_the_path_recovers(
        factors, closing, mode):
    qs = closing(port_server(factors, batching=True, serving_pipeline=mode,
                             max_batch=8, queue_deadline_ms=100.0))
    inner = qs.serving
    qs.serving = Wedged(inner, 0.8)
    results = burst(qs, [{"user": "u1", "num": 2}] * 12)
    assert all(isinstance(r, HTTPError) and r.status == 503
               for r in results)
    assert qs.deadline_exceeded == 12
    time.sleep(1.0)  # the wedge clears
    qs.serving = inner
    assert len(qs.batcher.submit({"user": "u2", "num": 2})["itemScores"]) \
        == 2


def test_expired_entries_never_join_a_batch():
    """At pickup an abandoned entry, or one past its deadline, completes
    with 503 and stays out of the batch (no launch for a caller that is
    gone); the rest batch in order."""
    q = queue.Queue()
    live = [es._Submit({"user": f"u{i}"}, 30.0) for i in range(3)]
    abandoned = es._Submit({"user": "gone"}, 30.0)
    abandoned.abandoned = True
    expired = es._Submit({"user": "late"}, 0.001)
    time.sleep(0.01)
    for e in (abandoned, live[1], expired, live[2]):
        q.put(e)
    batch = es._form_batch(q, live[0], max_batch=8, window=0.0)
    assert batch == live
    for e in (abandoned, expired):
        assert e.done.is_set() and e.result.status == 503
    assert not any(e.done.is_set() for e in live)


def test_a_close_sentinel_ends_the_batch_for_its_owner():
    q = queue.Queue()
    first, later = es._Submit({}, 0.0), es._Submit({}, 0.0)
    q.put(es._CLOSE)
    q.put(later)
    assert es._form_batch(q, first, max_batch=8, window=0.0) == [first]
    assert q.get_nowait() is later
    assert q.get_nowait() is es._CLOSE  # handed back for its drainer


@pytest.mark.parametrize("mode", MODES)
def test_deadline_zero_disables(factors, closing, mode):
    qs = closing(port_server(factors, batching=True, serving_pipeline=mode,
                             queue_deadline_ms=0.0))
    assert qs.batcher.deadline_sec == 0.0
    assert len(qs.batcher.submit({"user": "u1", "num": 2})["itemScores"]) \
        == 2
    assert qs.deadline_exceeded == 0


def test_microbatcher_deadline_signature_default():
    sig = inspect.signature(MicroBatcher.__init__)
    assert sig.parameters["deadline_ms"].default == 0.0
    assert sig.parameters["deadline_ms"].default \
        == inspect.signature(jes.MicroBatcher.__init__).parameters[
            "deadline_ms"].default


@pytest.mark.parametrize("mode", MODES)
def test_rebind_during_a_burst_never_serves_a_torn_binding(
        factors, closing, mode):
    """Queries flood the batch path while the binding flips between two
    models. Every answer is whole and from one of them; none fails."""
    qs = closing(port_server(factors, batching=True, serving_pipeline=mode,
                             max_batch=8, batch_window_ms=2.0))
    ep = qs.engine_params
    models = [port_model(factors), port_model(factors, scale=-1.0)]
    query = {"user": "u3", "num": 4}
    wants = []
    for m in models:
        qs._bind(ep, [m])
        wants.append(qs.query(query))
    assert wants[0] != wants[1]
    stop = threading.Event()
    rebind_errors = []

    def rebinder():
        k = 0
        while not stop.is_set():
            try:
                qs._bind(ep, [models[k % 2]])
            except Exception as e:  # noqa: BLE001 — surfaced below
                rebind_errors.append(e)
            k += 1

    results, lock = [], threading.Lock()

    def fire():
        for _ in range(20):
            r = qs.batcher.submit(query)
            with lock:
                results.append(r)

    rb = threading.Thread(target=rebinder)
    workers = [threading.Thread(target=fire) for _ in range(6)]
    rb.start()
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=30)
    stop.set()
    rb.join(timeout=10)
    assert not rb.is_alive() and not any(w.is_alive() for w in workers)
    assert not rebind_errors
    assert len(results) == 120
    items = [[s["item"] for s in w["itemScores"]] for w in wants]
    for r in results:
        assert not isinstance(r, HTTPError), r
        got = [s["item"] for s in r["itemScores"]]
        assert got in items
        assert_same(r, wants[items.index(got)], 1e-5)


def test_an_assembled_batch_keeps_its_binding(factors, closing):
    """The assemble-time snapshot rides the whole batch: a rebind after
    assemble swaps the server's lists, not the batch's."""
    qs = closing(port_server(factors, batching=True))
    ab = qs.batcher._assemble([es._Submit({"user": "u1", "num": 2})])
    old_models, old_binding = ab.models, ab.binding_id
    assert old_binding == qs.binding_id
    qs._bind(qs.engine_params, [port_model(factors, scale=2.0)])
    assert ab.models is old_models and qs.models is not old_models
    assert qs.binding_id != old_binding


def slow_render(monkeypatch, seconds=0.02):
    inner = es.to_jsonable

    def render(x):
        time.sleep(seconds)
        return inner(x)

    monkeypatch.setattr(es, "to_jsonable", render)


@pytest.mark.parametrize("mode", MODES)
def test_readback_phase_is_max_not_sum(factors, closing, monkeypatch, mode):
    """The batch's readback phase is the slowest query's rendering, not
    the sum over the batch."""
    qs = closing(port_server(factors, batching=True, serving_pipeline=mode))
    slow_render(monkeypatch)
    queries = [{"user": f"u{i}", "num": 3} for i in range(6)]
    if mode == "serial":
        out = qs.query_batch(queries)
    else:
        entries = [es._Submit(q) for q in queries]
        ab = qs.batcher._assemble(entries)
        results = qs.algorithms[0].batch_predict(qs.models[0], ab.queries)
        qs._finish_pipeline_batch(ab, results)
        assert all(e.done.is_set() for e in entries)
        out = [e.result for e in entries]
    assert all(len(r["itemScores"]) == 3 for r in out)
    assert qs.batches_served == 1
    readback = qs.phase_seconds["readback"]
    assert 0.02 <= readback < 0.06  # the sum would be >= 0.12


def test_unknown_pipeline_mode_rejected(factors):
    with pytest.raises(ValueError, match="serving_pipeline"):
        port_server(factors, batching=True, serving_pipeline="bogus")


def test_auto_depth_is_two_on_the_cpu(factors, closing):
    qs = closing(port_server(factors, batching=True))
    assert qs.batcher.depth == 2
    assert qs.pipeline_status()["depth"] == 2
    qs = closing(port_server(factors, batching=True, pipeline_depth=3))
    assert qs.batcher.depth == 3


class Supplementing(FirstServing):
    """A serving with a supplement of its own: concurrent supplements
    run on the server's pool."""

    def supplement(self, q):
        return q


@pytest.mark.parametrize("mode", MODES)
def test_close_leaves_no_pipeline_drainer_or_pool_thread(factors, mode):
    before = set(threading.enumerate())
    qs = port_server(factors, batching=True, serving_pipeline=mode,
                     batch_window_ms=20.0)
    qs.serving = Supplementing()
    burst(qs, [{"user": f"u{i}", "num": 3} for i in range(16)])
    started = {t.name for t in set(threading.enumerate()) - before}
    assert any(n.startswith("algo-batch-dispatch") for n in started)
    qs.close()
    qs.close()  # idempotent
    deadline = time.monotonic() + 10
    while set(threading.enumerate()) - before \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not set(threading.enumerate()) - before


@pytest.mark.parametrize("mode", MODES)
def test_status_json_shows_the_pipeline(factors, mode):
    engine = recommendation_engine()
    srv = es.deploy_models(engine, engine.params_from_variant(VARIANT),
                           [port_model(factors)],
                           ServerConfig(device="cpu", batching=True,
                                        serving_pipeline=mode),
                           "127.0.0.1", 0).start_background()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/queries.json",
            data=json.dumps({"user": "u1", "num": 2}).encode(),
            method="POST")
        with LOCAL.open(req, timeout=30) as resp:
            assert len(json.loads(resp.read())["itemScores"]) == 2
        with LOCAL.open(f"http://127.0.0.1:{srv.port}/status.json",
                        timeout=30) as resp:
            pipe = json.loads(resp.read())["pipeline"]
        assert pipe["mode"] == mode and pipe["deadlineMs"] == 30000.0
        assert pipe["deadlineExceeded"] == 0
        assert ("depth" in pipe) == (mode == "staged")
        assert pipe["overlap"]["deviceBusySec"] >= 0.0
    finally:
        srv.close()


# -- the readback split --------------------------------------------------------

def test_recommend_batch_is_dispatch_then_resolve(factors):
    model = port_model(factors)
    users = np.arange(N_USERS)[::-1].copy()
    ids_a, scores_a = als.recommend_batch(model, users, 7)
    ids_b, scores_b = als.recommend_batch_async(model, users, 7)()
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(scores_a, scores_b)
    assert ids_a.dtype == np.int64 and ids_a.shape == (N_USERS, 7)


def test_results_do_not_change_across_chunk_boundaries(factors,
                                                       monkeypatch):
    model = port_model(factors)
    users = np.random.default_rng(5).integers(0, N_USERS, 50)
    whole = als.recommend_batch(model, users, 10)
    monkeypatch.setattr(als, "_TOPK_CHUNK", 7)
    chunked = als.recommend_batch(model, users, 10)
    np.testing.assert_array_equal(whole[0], chunked[0])
    np.testing.assert_allclose(whole[1], chunked[1], rtol=1e-6)


def test_batches_resolve_in_any_order(factors):
    """Two dispatches in flight; the later resolves first, each with its
    own results."""
    model = port_model(factors)
    first = als.recommend_batch_async(model, np.arange(10), 5)
    second = als.recommend_batch_async(model, np.arange(10, 30), 5)
    ids2, _ = second()
    ids1, _ = first()
    np.testing.assert_array_equal(
        ids1, als.recommend_batch(model, np.arange(10), 5)[0])
    np.testing.assert_array_equal(
        ids2, als.recommend_batch(model, np.arange(10, 30), 5)[0])
