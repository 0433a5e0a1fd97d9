"""The port's releases against the JAX package's: the release registry's
blob read both ways on one shared SQLite store, the traffic splitter and
the health gate on the same inputs, the port's deploy and ``/reload``
binding a pin the JAX package wrote, the canary lifecycle on the CPU
(erroring candidate rolled back, healthy one promoted and pinned, shadow,
the route guards, a reload racing queries and a fold-in), and the
``release`` and ``undeploy`` commands.

Small sizes: 24 users x 24 items at rank 4, model blobs written by the
port's persistence (the port refuses the JAX package's pickles). Every
answer is held to the JAX template's ``predict`` on the factors of the
release that served it: the same items, scores within rtol 1e-5 (f32
serving).
"""

import json
import threading
import time
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

import predictionio_tpu.models.als as jals
import predictionio_tpu.obs.histogram as jhist
import predictionio_tpu.rollout as jrollout
import predictionio_tpu.rollout.splitter as jsplit
from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.data.storage.registry import Storage as JStorage
from predictionio_tpu.templates.recommendation import (
    ALSAlgorithm as JaxALSAlgorithm,
)
from predictionio_tpu.templates.recommendation import Query as JaxQuery
from predictionio_tpu_torch import cli
from predictionio_tpu_torch.controller.context import Context
from predictionio_tpu_torch.data.storage.base import (
    STATUS_COMPLETED,
    STATUS_INIT,
    App,
    EngineInstance,
    Model,
)
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.models.convert import als_model_from_numpy
from predictionio_tpu_torch.obs import histogram as phist
from predictionio_tpu_torch.rollout import (
    ArmWindow,
    HealthPolicy,
    ReleaseRegistry,
    TrafficSplitter,
    cohort_bucket,
)
from predictionio_tpu_torch.rollout import policy as ppolicy
from predictionio_tpu_torch.server.engineserver import (
    QueryServer,
    ServerConfig,
    create_engine_server,
    deploy,
    deploy_models,
)
from predictionio_tpu_torch.templates.recommendation import (
    recommendation_engine,
)
from predictionio_tpu_torch.workflow.core import load_models_for_deploy
from predictionio_tpu_torch.workflow.persistence import dumps_models

N_USERS, N_ITEMS, RANK = 24, 24, 4
ENGINE = ("rel", "1", "engine.json")
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
VARIANT = {"id": "rel",
           "algorithms": [{"name": "als", "params": {"rank": RANK}}]}

#: loopback only: no proxy from the environment may carry these requests
LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setattr(jals, "HOST_SERVE_WORK", 0)


def call(port, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    try:
        with LOCAL.open(req, timeout=30) as resp:
            raw = resp.read()
            ctype = resp.headers.get("Content-Type", "")
            return resp.status, (json.loads(raw) if "json" in ctype
                                 else raw.decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def factors(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N_USERS, RANK)).astype(np.float32),
            rng.standard_normal((N_ITEMS, RANK)).astype(np.float32))


def ids(prefix, n):
    return {f"{prefix}{i}": i for i in range(n)}


def port_model(seed):
    U, V = factors(seed)
    return als_model_from_numpy(U, V, N_USERS, N_ITEMS, ids("u", N_USERS),
                                ids("i", N_ITEMS), {"rank": RANK},
                                device="cpu")


def jax_answer(seed, q):
    U, V = factors(seed)
    model = jals.ALSModel(
        user_factors=U, item_factors=V, n_users=N_USERS, n_items=N_ITEMS,
        user_ids=JaxBiMap(ids("u", N_USERS)),
        item_ids=JaxBiMap(ids("i", N_ITEMS)),
        params=jals.ALSParams(rank=RANK))
    algo = JaxALSAlgorithm(jals.ALSParams(rank=RANK))
    return algo.predict(model, JaxQuery(user=q["user"],
                                        num=q["num"])).to_json()


def same(got, want, rtol=1e-5) -> bool:
    if [s["item"] for s in got["itemScores"]] \
            != [s["item"] for s in want["itemScores"]]:
        return False
    return bool(np.allclose([s["score"] for s in got["itemScores"]],
                            [s["score"] for s in want["itemScores"]],
                            rtol=rtol, atol=rtol))


def answered_by(q, got) -> set:
    """The seeds (releases) whose JAX answer equals ``got``."""
    return {seed for seed in SEEDS.values()
            if same(got, jax_answer(seed, q))}


#: the releases: instance id -> the seed of its factors
SEEDS = {"rl1": 1, "rl2": 2}


def add_release(storage, iid, minute, status=STATUS_COMPLETED):
    """A trained instance of ``ENGINE`` with its model blob written by
    the port's persistence."""
    start = T0 + timedelta(minutes=minute)
    storage.engine_instances().insert(EngineInstance(
        id=iid, status=status, start_time=start, end_time=start,
        engine_id=ENGINE[0], engine_version=ENGINE[1],
        engine_variant=ENGINE[2], engine_factory="synthetic"))
    storage.models().insert(Model(iid, dumps_models(
        [port_model(SEEDS.get(iid, 3))])))


def releases_store(storage):
    storage.apps().insert(App(0, "relapp"))
    add_release(storage, "rl1", 0)
    add_release(storage, "rl2", 1)
    return storage


@pytest.fixture()
def mem():
    return releases_store(
        Storage(env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"}))


@pytest.fixture()
def shared(tmp_path):
    """One SQLite ``PIO_HOME`` open in both packages."""
    env = {"PIO_HOME": str(tmp_path / "home")}
    st = releases_store(Storage(env=env))
    jst = JStorage(env=env)
    yield st, jst
    jst.close()
    st.close()


def engine_and_params():
    engine = recommendation_engine()
    return engine, engine.params_from_variant(VARIANT)


def serve(storage, iid, **cfg):
    """A storage-backed engine server bound to ``iid``."""
    engine, ep = engine_and_params()
    ctx = Context(device="cpu", _storage=storage)
    inst = storage.engine_instances().get(iid)
    qs = QueryServer(engine, ep, load_models_for_deploy(ctx, engine, inst,
                                                        ep),
                     ServerConfig(device="cpu", **cfg), inst, ctx)
    srv = create_engine_server(qs, "127.0.0.1", 0).start_background()
    return qs, srv


def deploy_from(storage, **cfg):
    engine, ep = engine_and_params()
    return deploy(Context(device="cpu", _storage=storage), engine, ep,
                  *ENGINE, config=ServerConfig(device="cpu", **cfg),
                  host="127.0.0.1", port=0)


# ---------------------------------------------------------------------------
# the registry's blob, both ways
# ---------------------------------------------------------------------------

def _drive(reg):
    """deploy, pin, canary, ramp, promote, candidate rollback, stable
    rollback, through either package's registry."""
    reg.record_deploy("rl1", actor="t", reason="first")
    reg.pin("rl1", actor="t", reason="known good")
    reg.start_candidate("rl2", 0.05, mode="canary", actor="gate")
    reg.set_fraction(0.25, actor="gate", reason="healthy")
    reg.promote("rl2", actor="gate", reason="healthy")
    reg.start_candidate("rl1", 1.0, mode="shadow", actor="op")
    reg.rollback(actor="op", reason="shadow done")
    reg.rollback(actor="op", reason="bad promote")


def _view(reg):
    st = reg.to_json(history_limit=1000)
    for e in st["history"]:
        e.pop("time")
    return reg.key, st, [e.action for e in reg.history()], \
        sorted(type(reg).list_tracked(reg.storage))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_registry_blob_reads_the_same_in_both_packages(shared, writer):
    st, jst = shared
    jreg = jrollout.ReleaseRegistry(jst, *ENGINE)
    preg = ReleaseRegistry(st, *ENGINE)
    _drive(jreg if writer == "jax" else preg)
    jkey, jstate, jactions, jtracked = _view(jreg)
    pkey, pstate, pactions, ptracked = _view(preg)
    assert pkey == jkey and pkey.startswith("__release__-")
    assert pstate == jstate
    assert pactions == jactions == [
        "deploy", "pin", "canary", "ramp", "promote", "shadow",
        "rollback", "rollback"]
    assert ptracked == jtracked == [ENGINE]
    assert pstate["state"]["stable"] == "rl1"
    assert pstate["state"]["pinned"] == "rl1"
    # the blob itself: the same bytes whichever package reads it
    assert st.models().get(pkey).models == jst.models().get(jkey).models


def test_registry_guards_match(shared):
    st, jst = shared
    for reg in (jrollout.ReleaseRegistry(jst, "g", "1", "v"),
                ReleaseRegistry(st, "g", "1", "v")):
        with pytest.raises(ValueError, match="not found"):
            reg.pin("nope")
        with pytest.raises(ValueError, match="nothing to roll back"):
            reg.rollback()
        assert reg.pinned_instance() is None
        reg.pin("rl1")
        reg.unpin(actor="t")
        assert reg.pinned_instance() is None


# ---------------------------------------------------------------------------
# splitter and health gate
# ---------------------------------------------------------------------------

def test_cohort_bucket_equals_the_jax_bucket():
    rng = np.random.default_rng(7)
    keys = [f"user=u{int(x)}" for x in rng.integers(0, 10**9, 10_000)]
    keys += ["", "é✓", "user=\udcff"]
    assert [cohort_bucket(k) for k in keys] \
        == [jsplit.cohort_bucket(k) for k in keys]


@pytest.mark.parametrize("fraction,shadow", [
    (0.0, False), (0.01, False), (0.1, False), (0.5, False), (1.0, False),
    (0.5, True), (1.0, True)])
def test_splitter_routes_as_the_jax_splitter(fraction, shadow):
    rng = np.random.default_rng(11)
    queries = [{"user": f"u{int(x)}", "num": 3}
               for x in rng.integers(0, 10**6, 2000)]
    queries += [{"num": 3}, {"items": ["i1", "i2"]}, {"item": "i9"},
                {"userId": 5}, ["not", "a", "dict"], None]
    p = TrafficSplitter(fraction, shadow=shadow)
    j = jsplit.TrafficSplitter(fraction, shadow=shadow)
    assert [p.cohort_key(q) for q in queries] \
        == [j.cohort_key(q) for q in queries]
    assert [p.routes_candidate(q) for q in queries] \
        == [j.routes_candidate(q) for q in queries]
    assert [p.route(q) for q in queries] == [j.route(q) for q in queries]
    if 0.0 < fraction < 1.0:  # monotone: a ramp step only adds cohort
        hi = TrafficSplitter(min(1.0, fraction * 2))
        assert all(hi.routes_candidate(q) for q in queries
                   if p.routes_candidate(q))


@pytest.mark.parametrize("value", ["5%", "0.05", 0.5, 1, "100%", "0", "1.5",
                                   "-1", None])
def test_parse_fraction_matches(value):
    def outcome(fn):
        try:
            return fn(value)
        except ValueError:
            return "ValueError"

    from predictionio_tpu_torch.rollout.splitter import parse_fraction

    assert outcome(parse_fraction) == outcome(jsplit.parse_fraction)


#: JAX ``tests/test_rollout.py::TestPolicy::test_verdicts``: (stable,
#: candidate, verdict) under one policy
VERDICT_CASES = [
    ((100, 1, 0.010), (3, 0, None), "hold"),
    ((100, 1, 0.010), (50, 20, 0.01), "rollback"),
    ((100, 8, 0.010), (50, 4, 0.01), "advance"),
    ((100, 1, 0.010), (50, 0, 0.05), "rollback"),
    ((100, 1, 0.010), (50, 0, 0.012), "advance"),
]


@pytest.mark.parametrize("stable,candidate,verdict", VERDICT_CASES)
def test_gate_verdicts_match(stable, candidate, verdict):
    kw = dict(min_queries=10, max_error_rate=0.1, error_rate_slack=0.05,
              p99_regression=2.0)
    got = HealthPolicy(**kw).evaluate(ArmWindow(*stable),
                                      ArmWindow(*candidate))
    want = jrollout.HealthPolicy(**kw).evaluate(
        jrollout.ArmWindow(*stable), jrollout.ArmWindow(*candidate))
    assert got.to_json() == want.to_json() and got.action == verdict


def test_gate_on_seeded_windows_matches():
    rng = np.random.default_rng(5)
    p, j = HealthPolicy(), jrollout.HealthPolicy()
    for _ in range(500):
        q = [int(x) for x in rng.integers(0, 60, 2)]
        e = [int(rng.integers(0, n + 1)) for n in q]
        lat = [None if rng.random() < 0.1 else float(rng.exponential(0.01))
               for _ in q]
        got = p.evaluate(ArmWindow(q[0], e[0], lat[0]),
                         ArmWindow(q[1], e[1], lat[1]))
        want = j.evaluate(jrollout.ArmWindow(q[0], e[0], lat[0]),
                          jrollout.ArmWindow(q[1], e[1], lat[1]))
        assert got.to_json() == want.to_json()
    assert p.to_json() == j.to_json()


@pytest.mark.parametrize("ramp", [ppolicy.DEFAULT_RAMP, (0.25, 1.0),
                                  (0.5,)])
def test_ramp_schedule_matches(ramp):
    p = HealthPolicy(ramp=ramp)
    j = jrollout.HealthPolicy(ramp=ramp)
    for f in (0.0, 0.01, 0.03, 0.05, 0.25, 0.5, 0.99, 1.0):
        assert p.next_fraction(f) == j.next_fraction(f)
    assert HealthPolicy().next_fraction(0.01) == 0.05
    assert HealthPolicy().next_fraction(1.0) is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_quantile_matches(seed):
    rng = np.random.default_rng(seed)
    bounds = phist.exponential_bounds(0.001, 2.0, 12)
    assert bounds == jhist.exponential_bounds(0.001, 2.0, 12)
    h, jh = phist.StreamingHistogram(bounds), jhist.StreamingHistogram(bounds)
    for v in rng.exponential(0.005, 300):
        h.observe(v)
        jh.observe(v)
    start, jstart = h.bucket_counts(), jh.bucket_counts()
    for v in rng.exponential(0.05, 120):  # the window's traffic: slower
        h.observe(v)
        jh.observe(v)
    assert h.bucket_counts() == jh.bucket_counts()
    for q in (0.5, 0.9, 0.99, 1.0):
        got = ppolicy.window_quantile(start, h.bucket_counts(), q)
        assert got == jhist.window_quantile(jstart, jh.bucket_counts(), q)
    assert h.snapshot() == jh.snapshot()
    # an empty, a wrapped and a mismatched window have no quantile
    assert ppolicy.window_quantile(start, start, 0.99) is None
    assert ppolicy.window_quantile(h.bucket_counts(), start, 0.99) is None
    assert ppolicy.window_quantile(start, start[1:], 0.99) is None


# ---------------------------------------------------------------------------
# deploy and /reload against a pin the JAX package wrote
# ---------------------------------------------------------------------------

QUERIES = [{"user": f"u{u}", "num": n} for u, n in
           ((0, 3), (5, 1), (11, 24), (23, 6))]


def assert_serves(port, seed):
    for q in QUERIES:
        status, got = call(port, "POST", "/queries.json", q)
        assert status == 200 and same(got, jax_answer(seed, q)), q


def test_deploy_and_reload_bind_a_jax_pin(shared):
    st, jst = shared
    jreg = jrollout.ReleaseRegistry(jst, *ENGINE)
    # without a pin the latest COMPLETED (rl2); with the JAX package's
    # pin on rl1, rl1
    jreg.pin("rl1", actor="jax", reason="known good")
    srv = deploy_from(st, batching=True).start_background()
    try:
        status, body = call(srv.port, "GET", "/status.json")
        assert body["engineInstanceId"] == "rl1"
        assert (body["engineId"], body["engineVersion"],
                body["engineVariant"]) == ENGINE
        assert body["release"]["pinned"] == "rl1"
        assert_serves(srv.port, SEEDS["rl1"])
        # the JAX package moves the pin; the port's /reload follows it
        jreg.pin("rl2", actor="jax")
        status, body = call(srv.port, "POST", "/reload")
        assert (status, body["engineInstanceId"]) == (200, "rl2")
        assert call(srv.port, "GET",
                    "/status.json")[1]["engineInstanceId"] == "rl2"
        assert_serves(srv.port, SEEDS["rl2"])
        # unpinned: the latest COMPLETED
        jreg.unpin(actor="jax")
        assert call(srv.port, "POST", "/reload")[1]["engineInstanceId"] \
            == "rl2"
    finally:
        srv.close()
    # both deploys and the reloads are in the history the JAX package reads
    actions = [(e.action, e.actor) for e in jreg.history()]
    assert actions.count(("deploy", "pio deploy")) == 1
    assert actions.count(("deploy", "/reload")) == 2
    assert jreg.state()["stable"] == "rl2"
    assert jreg.state()["previousStable"] == "rl1"


def test_a_pin_on_an_instance_not_completed(shared):
    st, jst = shared
    jreg = jrollout.ReleaseRegistry(jst, *ENGINE)
    srv = deploy_from(st).start_background()
    add_release(st, "rl3", 2)
    try:
        jreg.pin("rl3", actor="jax")
        inst = st.engine_instances().get("rl3")
        st.engine_instances().update(inst.copy(status=STATUS_INIT))
        status, body = call(srv.port, "POST", "/reload")
        assert status == 409 and "rl3" in body["message"]
        # the serving binding is untouched
        assert call(srv.port, "GET",
                    "/status.json")[1]["engineInstanceId"] == "rl2"
    finally:
        srv.close()
    with pytest.raises(RuntimeError, match="Pinned release 'rl3'"):
        deploy_from(st)
    st.engine_instances().delete("rl3")
    with pytest.raises(RuntimeError, match="not a COMPLETED"):
        deploy_from(st)


def test_reload_with_nothing_completed_is_404(mem):
    qs, srv = serve(mem, "rl1")
    try:
        for iid in ("rl1", "rl2"):
            inst = mem.engine_instances().get(iid)
            mem.engine_instances().update(inst.copy(status=STATUS_INIT))
        status, _ = call(srv.port, "POST", "/reload")
        assert status == 404
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# the canary lifecycle
# ---------------------------------------------------------------------------

class PoisonServing:
    """Candidate serving that always fails: the bad retrain."""

    def supplement(self, q):
        raise RuntimeError("candidate poison")

    def serve(self, q, ps):  # pragma: no cover — supplement raises
        raise RuntimeError("candidate poison")


def drive_until(port, pred, timeout=30.0):
    """Query traffic over every user until ``pred()`` or the timeout;
    the (query, status, body) triples."""
    results = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not pred():
        for u in range(N_USERS):
            q = {"user": f"u{u}", "num": 2}
            results.append((q, *call(port, "POST", "/queries.json", q)))
        time.sleep(0.02)
    return results


@pytest.mark.parametrize("batching", [False, True])
def test_an_erroring_candidate_rolls_back(mem, batching):
    qs, srv = serve(mem, "rl1", batching=batching)
    try:
        policy = HealthPolicy(window_sec=0.2, min_queries=5,
                              ramp=(0.5, 1.0), max_error_rate=0.2)
        ctl = qs.start_canary("rl2", fraction=0.5, policy=policy,
                              actor="test", reason="bad retrain")
        assert qs.candidate_instance_id == "rl2"
        qs._candidate.serving = PoisonServing()
        results = drive_until(srv.port, lambda: not ctl.active)
        assert not ctl.active and ctl.outcome == "rolled_back"
        assert qs.candidate_instance_id is None
        assert qs.instance.id == "rl1"
        # some candidate 500s while it was live; every 200 from stable
        assert any(status == 500 for _, status, _ in results)
        for q, status, body in results:
            if status == 200:
                assert answered_by(q, body) == {SEEDS["rl1"]}
        assert_serves(srv.port, SEEDS["rl1"])
        status, rel = call(srv.port, "GET", "/release.json")
        actions = [e["action"] for e in rel["history"]]
        assert "canary" in actions and "rollback" in actions
        assert rel["rollout"]["outcome"] == "rolled_back"
        assert rel["serving"]["stableInstanceId"] == "rl1"
        assert rel["arms"]["candidate"]["errors"] > 0
        assert rel["arms"]["stable"]["errors"] == 0
        assert rel["arms"]["stable"]["queries"] > 0
    finally:
        srv.close()


@pytest.mark.parametrize("batching", [False, True])
def test_a_healthy_candidate_ramps_to_the_pinned_stable(mem, batching):
    qs, srv = serve(mem, "rl1", batching=batching)
    try:
        # the p99 gate is out of the way here (a 3-query sample flips the
        # 2x rule on one scheduler hiccup); the verdicts test holds it
        policy = HealthPolicy(window_sec=0.15, min_queries=3,
                              ramp=(0.25, 1.0), p99_regression=1000.0)
        ctl = qs.start_canary("rl2", policy=policy, actor="test",
                              reason="healthy retrain")
        assert ctl.splitter.fraction == 0.25
        results = drive_until(srv.port, lambda: not ctl.active)
        assert not ctl.active and ctl.outcome == "promoted"
        assert all(status == 200 for _, status, _ in results)
        # each answer is whole from one release; the first ramp step's
        # cohort only ever sees the candidate
        for q, _, body in results:
            arms = answered_by(q, body)
            assert len(arms) == 1, (q, body)
            if cohort_bucket(f"user={q['user']}") < 0.25:
                assert arms == {SEEDS["rl2"]}
        assert qs.instance.id == "rl2"
        st = qs.releases.state()
        assert st["stable"] == "rl2" and st["pinned"] == "rl2"
        actions = [e.action for e in qs.releases.history()]
        assert actions[-3:] == ["canary", "ramp", "promote"]
        status, body = call(srv.port, "GET", "/status.json")
        assert body["release"]["stable"] == "rl2"
        assert body["engineInstanceId"] == "rl2"
        # /reload now binds the pinned (promoted) release
        status, body = call(srv.port, "POST", "/reload")
        assert status == 200 and body["engineInstanceId"] == "rl2"
        assert_serves(srv.port, SEEDS["rl2"])
        status, text = call(srv.port, "GET", "/metrics")
        assert 'pio_release_queries_total{arm="candidate"}' in text
        assert "pio_release_promotions_total 1" in text
    finally:
        srv.close()


def test_shadow_mirrors_without_changing_any_answer(mem):
    qs, srv = serve(mem, "rl1", batching=True)
    try:
        policy = HealthPolicy(window_sec=0.2, min_queries=3)
        ctl = qs.start_canary("rl2", shadow=True, policy=policy,
                              actor="test")
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and ctl.windows < 2:
            for u in range(10):
                q = {"user": f"u{u}", "num": 2}
                status, body = call(srv.port, "POST", "/queries.json", q)
                assert status == 200
                assert answered_by(q, body) == {SEEDS["rl1"]}
            time.sleep(0.02)
        assert ctl.windows >= 2, "gate windows did not evaluate"
        # a healthy shadow never promotes by itself
        assert ctl.active and qs.instance.id == "rl1"
        actions = [e.action for e in qs.releases.history()]
        assert "shadow" in actions and "shadow-window" in actions
        # even a poisoned shadow never reaches a caller
        qs._candidate.serving = PoisonServing()
        for u in range(10):
            q = {"user": f"u{u}", "num": 2}
            assert answered_by(q, call(srv.port, "POST", "/queries.json",
                                       q)[1]) == {SEEDS["rl1"]}
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline \
                and qs.release_arm_snapshot("candidate")[1] == 0:
            time.sleep(0.02)
        assert qs.release_arm_snapshot("candidate")[1] > 0
        status, text = call(srv.port, "GET", "/metrics")
        mirrors = [ln for ln in text.splitlines()
                   if ln.startswith("pio_release_shadow_mirrors_total ")]
        assert mirrors and float(mirrors[0].split()[1]) >= 20
        status, body = call(srv.port, "POST", "/release/rollback")
        assert status == 200 and body["engineInstanceId"] == "rl1"
        assert not ctl.active and qs.candidate_instance_id is None
    finally:
        srv.close()


def test_the_route_guards(mem):
    qs, srv = serve(mem, "rl1")
    try:
        # nothing to roll back: no candidate, no previous stable
        assert call(srv.port, "POST", "/release/rollback")[0] == 409
        qs.releases.record_deploy("rl1", actor="test")
        for body, code in (({"instanceId": "nope"}, 404),
                           ({"instanceId": "rl1"}, 400),  # the stable
                           ({}, 400),
                           ({"instanceId": "rl2", "fraction": 2}, 400),
                           ({"instanceId": "rl2", "windowSec": 0}, 400)):
            assert call(srv.port, "POST", "/release/canary",
                        body)[0] == code, body
        add_release(mem, "rl4", 3, status=STATUS_INIT)
        assert call(srv.port, "POST", "/release/canary",
                    {"instanceId": "rl4"})[0] == 400
        assert call(srv.port, "POST", "/release/promote")[0] == 409
        with pytest.raises(Exception) as e:
            qs.serve_candidate({"user": "u1", "num": 2})
        assert getattr(e.value, "status", None) == 503
        status, body = call(srv.port, "POST", "/release/canary",
                            {"instanceId": "rl2", "fraction": 0.5,
                             "windowSec": 60, "reason": "via http"})
        assert status == 200 and body["rollout"]["fraction"] == 0.5
        assert body["rollout"]["policy"]["windowSec"] == 60
        assert call(srv.port, "POST", "/release/canary",
                    {"instanceId": "rl2"})[0] == 409
        # a malformed query on the candidate arm is the client's 400,
        # not an error of the arm
        bad = next({"usr": f"x{k}"} for k in range(100) if cohort_bucket(
            json.dumps({"usr": f"x{k}"}, sort_keys=True)) < 0.5)
        assert call(srv.port, "POST", "/queries.json", bad)[0] == 400
        assert qs.release_arm_snapshot("candidate")[1] == 0
        status, body = call(srv.port, "POST", "/release/promote")
        assert status == 200 and body["engineInstanceId"] == "rl2"
        assert qs.instance.id == "rl2"
        assert_serves(srv.port, SEEDS["rl2"])
        # with no candidate, rollback reverts to the previous stable
        status, body = call(srv.port, "POST", "/release/rollback")
        assert (status, body["engineInstanceId"]) == (200, "rl1")
        assert qs.releases.state()["pinned"] == "rl1"
        assert_serves(srv.port, SEEDS["rl1"])
    finally:
        srv.close()


def test_models_handed_in_have_no_releases():
    engine, ep = engine_and_params()
    srv = deploy_models(engine, ep, [port_model(1)],
                        ServerConfig(device="cpu"), "127.0.0.1",
                        0).start_background()
    try:
        for method, path in (("GET", "/release.json"), ("POST", "/reload"),
                             ("POST", "/release/promote"),
                             ("POST", "/release/rollback")):
            assert call(srv.port, method, path)[0] == 409, path
        assert call(srv.port, "POST", "/release/canary",
                    {"instanceId": "rl2"})[0] == 409
        st = call(srv.port, "GET", "/status.json")[1]
        assert st["engineId"] is None and st["release"]["stable"] is None
        assert_serves(srv.port, 1)
    finally:
        srv.close()


def test_a_reload_racing_queries_and_a_fold_in(mem):
    """Queries through the staged pipeline while ``/reload`` flips the
    binding between two releases: every answer is whole from one of
    them. A fold-in computed against the old binding is voided."""
    qs, srv = serve(mem, "rl1", batching=True)
    reg = ReleaseRegistry(mem, *ENGINE)
    stop = threading.Event()
    results, errors = [], []

    def client(k):
        u = 0
        while not stop.is_set():
            q = {"user": f"u{(u * 7 + k) % N_USERS}", "num": 5}
            try:
                results.append((q, *call(srv.port, "POST",
                                         "/queries.json", q)))
            except Exception as e:  # noqa: BLE001 — asserted empty below
                errors.append(e)
            u += 1

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(6)]
    try:
        for t in threads:
            t.start()
        for i in range(8):
            target = ("rl2", "rl1")[i % 2]
            reg.pin(target, actor="test")
            base, model = qs.stream_snapshot(0)
            assert call(srv.port, "POST",
                        "/reload")[1]["engineInstanceId"] == target
            if base != target:
                # the fold-in computed against the old binding loses
                assert qs.apply_stream_delta(0, model, ["u0"], base) is False
            time.sleep(0.05)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        srv.close()
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(results) > 20
    seen = set()
    for q, status, body in results:
        assert status == 200
        arms = answered_by(q, body)
        assert len(arms) == 1, (q, body)
        seen |= arms
    assert seen == set(SEEDS.values())


# ---------------------------------------------------------------------------
# release and undeploy commands
# ---------------------------------------------------------------------------

def _single(storage_iid="i1"):
    st = Storage(env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
    now = datetime.now(timezone.utc)
    st.engine_instances().insert(EngineInstance(
        id=storage_iid, status=STATUS_COMPLETED, start_time=now,
        end_time=now, engine_id="e", engine_version="1",
        engine_variant="v", engine_factory="f"))
    return st


def test_release_list_show_pin(capsys):
    st = _single()
    assert cli.main(["release", "list"], storage=st) == 0
    assert "No releases" in capsys.readouterr().out
    assert cli.main(["release", "pin", "i1", "--engine-id", "e",
                     "--engine-json", "v", "--reason", "known good"],
                    storage=st) == 0
    assert cli.main(["release", "list"], storage=st) == 0
    out = capsys.readouterr().out
    assert "e v1" in out and "pinned=i1" in out
    assert cli.main(["release", "show", "--engine-id", "e",
                     "--engine-json", "v"], storage=st) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["state"]["pinned"] == "i1"
    assert payload["history"][-1]["reason"] == "known good"
    assert cli.main(["release", "pin", "nope", "--engine-id", "e",
                     "--engine-json", "v"], storage=st) == 1
    assert cli.main(["release", "pin", "--engine-id", "e",
                     "--engine-json", "v"], storage=st) == 1
    assert cli.main(["release", "pin", "--clear", "--engine-id", "e",
                     "--engine-json", "v"], storage=st) == 0
    assert ReleaseRegistry(st, "e", "1", "v").pinned_instance() is None


def test_release_pin_through_the_cli_binds_in_the_jax_package(shared):
    st, jst = shared
    assert cli.main(["release", "pin", "rl1", "--engine-id", ENGINE[0],
                     "--engine-json", ENGINE[2]], storage=st) == 0
    assert jrollout.ReleaseRegistry(jst, *ENGINE).pinned_instance() == "rl1"


def test_undeploy_records_history(mem, capsys):
    qs, srv = serve(mem, "rl1")
    try:
        assert cli.main(["undeploy", "--ip", "127.0.0.1", "--port",
                         str(srv.port)], storage=mem) == 0
        assert "rl1" in capsys.readouterr().out
        undeploys = [e for e in ReleaseRegistry(mem, *ENGINE).history()
                     if e.action == "undeploy"]
        assert undeploys and undeploys[-1].instance_id == "rl1"
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            try:
                call(srv.port, "GET", "/status.json")
            except OSError:
                break
            time.sleep(0.05)
        else:
            pytest.fail("the server still answers after undeploy")
    finally:
        srv.close()
    # nothing listening: undeploy fails
    assert cli.main(["undeploy", "--port", str(srv.port)],
                    storage=mem) == 1


def test_release_status_falls_back_to_storage(capsys):
    st = _single()
    ReleaseRegistry(st, "default", "1", "engine.json").record_deploy("i1")
    assert cli.main(["release", "status", "--port", "1"], storage=st) == 0
    captured = capsys.readouterr()
    assert "unreachable" in captured.err
    assert json.loads(captured.out)["state"]["stable"] == "i1"


def test_release_canary_promote_rollback_through_the_cli(mem, capsys):
    srv = deploy_from(mem).start_background()  # the latest: rl2
    args = ["--port", str(srv.port), "--engine-id", ENGINE[0],
            "--engine-json", ENGINE[2]]
    try:
        assert cli.main(["release", "canary", "rl1", "--fraction", "50%",
                         *args], storage=mem) == 0
        assert "rollout of rl1 started at 50%" in capsys.readouterr().out
        assert cli.main(["release", "status", *args], storage=mem) == 0
        assert json.loads(capsys.readouterr().out)["rollout"][
            "candidateInstanceId"] == "rl1"
        assert cli.main(["release", "promote", *args], storage=mem) == 0
        assert "Serving instance: rl1" in capsys.readouterr().out
        assert cli.main(["release", "rollback", *args], storage=mem) == 0
        assert "Serving instance: rl2" in capsys.readouterr().out
        assert cli.main(["release", "promote", *args], storage=mem) == 1
        assert "409" in capsys.readouterr().err
    finally:
        srv.close()
