"""The port's ``workflow/batch_predict.py`` against the JAX package's:
the batch path's error contract and phase timings, ``batch_predict_lines``
and ``run_batch_predict`` on the same model, and ``cli batchpredict
--device cpu`` in the flow of ``tests/test_cli.py::
test_build_train_batchpredict``.

The model is 64 users x 40 items at rank 8, factors from a numpy seed.
Queries match exactly; item ids exactly; scores within rel 1e-5 (f32).
The JAX side runs on the CPU through its device path (``HOST_SERVE_WORK =
0``, test-side only); the port on ``device="cpu"``.
"""

import json
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

import predictionio_tpu.models.als as jals
import predictionio_tpu.workflow.batch_predict as jbp
from predictionio_tpu.controller import Context as JContext
from predictionio_tpu.data.bimap import BiMap as JBiMap
from predictionio_tpu.data.storage import Storage as JStorage
from predictionio_tpu.data.storage.base import STATUS_COMPLETED as J_DONE
from predictionio_tpu.data.storage.base import EngineInstance as JInstance
from predictionio_tpu.data.storage.base import Model as JModel
from predictionio_tpu.templates.recommendation import (
    default_engine_params as jax_engine_params,
)
from predictionio_tpu.templates.recommendation import (
    recommendation_engine as jax_engine,
)
from predictionio_tpu.workflow import persistence as jpersistence
from predictionio_tpu_torch import cli
from predictionio_tpu_torch.controller.context import Context
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import (
    STATUS_COMPLETED,
    EngineInstance,
    Model,
)
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.models.convert import als_model_from_numpy
from predictionio_tpu_torch.templates.recommendation import (
    ALSAlgorithm,
    Query,
    recommendation_engine,
)
from predictionio_tpu_torch.workflow import batch_predict as pbp
from predictionio_tpu_torch.workflow.persistence import (
    dumps_models,
    loads_models,
)

N_USERS, N_ITEMS, RANK = 64, 40, 8
VARIANT = {"id": "bp", "version": "1",
           "algorithms": [{"name": "als", "params": {"rank": RANK}}]}


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setattr(jals, "HOST_SERVE_WORK", 0)


@pytest.fixture(scope="module")
def factors():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((N_USERS, RANK)).astype(np.float32),
            rng.standard_normal((N_ITEMS, RANK)).astype(np.float32))


def ids(prefix, n):
    return {f"{prefix}{i}": i for i in range(n)}


def jax_model(factors):
    U, V = factors
    return jals.ALSModel(
        user_factors=U, item_factors=V, n_users=N_USERS, n_items=N_ITEMS,
        user_ids=JBiMap(ids("u", N_USERS)),
        item_ids=JBiMap(ids("i", N_ITEMS)),
        params=jals.ALSParams(rank=RANK))


def port_model(factors):
    U, V = factors
    return als_model_from_numpy(U, V, N_USERS, N_ITEMS, ids("u", N_USERS),
                                ids("i", N_ITEMS), {"rank": RANK},
                                device="cpu")


def query_lines(n=23, seed=3):
    """Query lines with blank lines, blacklists and unknown users."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        q = {"user": f"u{rng.integers(0, N_USERS)}",
             "num": int(rng.integers(1, 12))}
        if k % 4 == 1:
            q["blackList"] = [f"i{j}" for j in rng.integers(0, N_ITEMS, 3)]
        if k % 7 == 3:
            q["user"] = f"nobody{k}"
        out.append(json.dumps(q))
        if k % 5 == 2:
            out.append("   ")
    return out


def assert_same_lines(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = json.loads(g), json.loads(w)
        assert g["query"] == w["query"]
        gs, ws = g["prediction"]["itemScores"], w["prediction"]["itemScores"]
        assert [s["item"] for s in gs] == [s["item"] for s in ws]
        np.testing.assert_allclose([s["score"] for s in gs],
                                   [s["score"] for s in ws],
                                   rtol=1e-5, atol=1e-5)


# -- the batch path's contract -----------------------------------------------

class Boom(Exception):
    pass


class FakeServing:
    def supplement(self, q):
        if q == "bad-supplement":
            raise Boom("supplement")
        return q + "+s"

    def serve(self, q, predictions):
        if q == "bad-serve":
            raise Boom("serve")
        return "|".join(predictions)


class AsyncAlgo:
    """Launches at dispatch and waits in its resolver."""

    def __init__(self, fail_at=None):
        self.fail_at = fail_at

    def batch_predict_async(self, model, queries):
        if self.fail_at == "dispatch":
            raise Boom("dispatch")

        def resolve():
            if self.fail_at == "resolve":
                raise Boom("resolve")
            return [f"{model}:{q}" for q in queries]

        return resolve


class BlockingAlgo:
    """Only the blocking ``batch_predict``."""

    def __init__(self, fail_at=None):
        self.fail_at = fail_at

    def batch_predict(self, model, queries):
        if self.fail_at in ("dispatch", "resolve"):
            raise Boom(self.fail_at)
        return [f"{model}:{q}" for q in queries]


def shape(results):
    return [("Boom", str(r)) if isinstance(r, Boom) else r for r in results]


@pytest.mark.parametrize("pooled", [False, True])
@pytest.mark.parametrize("fail_at", [None, "dispatch", "resolve"])
@pytest.mark.parametrize("algo", [AsyncAlgo, BlockingAlgo])
def test_batch_path_error_contract_matches_jax(algo, fail_at, pooled):
    """A failing supplement or serve fills only its slot; a failing
    launch or resolve fills every live slot; the timings carry the JAX
    package's keys. Two algorithms, so serve sees both predictions."""
    queries = ["a", "bad-supplement", "b", "bad-serve", "c"]
    algos = [algo(fail_at), AsyncAlgo()]
    want_t, got_t = {}, {}
    want = jbp.predict_serve_batch(algos, ["m0", "m1"], FakeServing(),
                                   queries, timings=want_t)
    pool = pbp.make_pool() if pooled else None
    try:
        got = pbp.predict_serve_batch(algos, ["m0", "m1"], FakeServing(),
                                      queries, timings=got_t, pool=pool)
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
    assert shape(got) == shape(want)
    assert set(got_t) == set(want_t)
    assert set(got_t) <= {"supplement", "dispatch", "device_wait", "serve"}
    if fail_at is None:
        assert got[0] == "m0:a+s|m1:a+s"
        assert isinstance(got[3], Boom)


def test_pending_batch_resolves_what_dispatch_launched():
    """dispatch_serve_batch launches and returns; resolve() reads back
    and serves (the staged pipeline's split)."""
    algo = AsyncAlgo()
    calls = []
    inner = algo.batch_predict_async

    def spy(model, queries):
        calls.append(list(queries))
        return inner(model, queries)

    algo.batch_predict_async = spy
    pending = pbp.dispatch_serve_batch([algo], ["m"], FakeServing(),
                                       ["x", "y"])
    assert calls == [["x+s", "y+s"]] and pending.live == [0, 1]
    assert pending.resolve() == ["m:x+s", "m:y+s"]


# -- batch prediction --------------------------------------------------------

@pytest.mark.parametrize("batch_size", [5, 1024])
def test_batch_predict_lines_match_jax(factors, batch_size):
    lines = query_lines()
    jengine = jax_engine()
    want = list(jbp.batch_predict_lines(
        jengine, jax_engine_params("bp", rank=RANK), [jax_model(factors)],
        lines, batch_size=batch_size))
    engine = recommendation_engine()
    got = list(pbp.batch_predict_lines(
        engine, engine.params_from_variant(VARIANT), [port_model(factors)],
        lines, batch_size=batch_size, device="cpu"))
    assert len(got) == sum(1 for ln in lines if ln.strip())
    assert_same_lines(got, want)


def test_a_malformed_query_fails_the_job(factors):
    engine = recommendation_engine()
    with pytest.raises((TypeError, ValueError)):
        list(pbp.batch_predict_lines(
            engine, engine.params_from_variant(VARIANT),
            [port_model(factors)], ['{"usr": "u1"}'], device="cpu"))


def test_batch_predict_runs_on_the_card_unless_asked(factors, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    engine = recommendation_engine()
    with pytest.raises(RuntimeError, match="CUDA"):
        list(pbp.batch_predict_lines(
            engine, engine.params_from_variant(VARIANT),
            [port_model(factors)], ['{"user": "u1"}']))


def jax_store_with_model(factors):
    storage = JStorage(env={"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})
    now = datetime.now(timezone.utc)
    inst = JInstance(
        id="j0", status=J_DONE, start_time=now, end_time=now,
        engine_id="bp", engine_version="1", engine_variant="engine.json",
        engine_factory="synthetic")
    storage.engine_instances().insert(inst)
    ep = jax_engine_params("bp", rank=RANK)
    algo = jax_engine().make_algorithms(ep)[0]
    stored = [algo.make_persistent_model(jax_model(factors), inst.id, 0)]
    storage.models().insert(JModel(
        id=inst.id, models=jpersistence.dumps_models(stored)))
    return storage, ep


@pytest.fixture(params=["memory", "sqlite"])
def port_store(request, tmp_path):
    env = ({"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"}
           if request.param == "memory"
           else {"PIO_HOME": str(tmp_path / "home")})
    st = Storage(env=env)
    yield st
    st.close()


def test_run_batch_predict_through_each_store(factors, port_store,
                                              tmp_path):
    qfile = tmp_path / "queries.jsonl"
    qfile.write_text("\n".join(query_lines()) + "\n")
    jstore, jep = jax_store_with_model(factors)
    n_jax = jbp.run_batch_predict(
        JContext(_storage=jstore), jax_engine(), jep, str(qfile),
        str(tmp_path / "jax.jsonl"), engine_id="bp")
    now = datetime.now(timezone.utc)
    inst_id = port_store.engine_instances().insert(EngineInstance(
        id="", status=STATUS_COMPLETED, start_time=now, end_time=now,
        engine_id="bp", engine_version="1", engine_variant="engine.json",
        engine_factory=""))
    port_store.models().insert(Model(id=inst_id, models=dumps_models(
        [port_model(factors)])))
    engine = recommendation_engine()
    n = pbp.run_batch_predict(
        Context(device="cpu", _storage=port_store), engine,
        engine.params_from_variant(VARIANT), str(qfile),
        str(tmp_path / "port.jsonl"), engine_id="bp", batch_size=4)
    assert n == n_jax == sum(1 for ln in query_lines() if ln.strip())
    assert_same_lines((tmp_path / "port.jsonl").read_text().splitlines(),
                      (tmp_path / "jax.jsonl").read_text().splitlines())


def test_run_batch_predict_needs_a_completed_instance(port_store, tmp_path):
    (tmp_path / "q.jsonl").write_text('{"user": "u1"}\n')
    engine = recommendation_engine()
    with pytest.raises(RuntimeError, match="COMPLETED"):
        pbp.run_batch_predict(
            Context(device="cpu", _storage=port_store), engine,
            engine.params_from_variant(VARIANT), str(tmp_path / "q.jsonl"),
            str(tmp_path / "out.jsonl"))


def seed_ratings(storage, app_name="cliapp"):
    """``tests/test_cli.py``'s ratings: 20 users, 5 items each."""
    assert cli.main(["app", "new", app_name], storage=storage) == 0
    app_id = storage.apps().get_by_name(app_name).id
    rng = np.random.default_rng(2)
    t = datetime(2026, 1, 1, tzinfo=timezone.utc)
    events = []
    for u in range(20):
        pool = range(0, 8) if u % 2 == 0 else range(8, 16)
        for i in rng.choice(list(pool), size=5, replace=False):
            events.append(Event(
                event="rate", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{i}",
                properties={"rating": 5.0}, event_time=t))
            t += timedelta(minutes=1)
    storage.events().insert_batch(events, app_id)


def test_cli_train_batchpredict_on_the_cpu(tmp_path, capsys):
    st = Storage(env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
    seed_ratings(st)
    ej = tmp_path / "engine.json"
    ej.write_text(json.dumps({
        "id": "cli-engine", "version": "1",
        "engineFactory": "predictionio_tpu.templates.recommendation:"
                         "recommendation_engine",
        "datasource": {"params": {"app_name": "cliapp"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 8, "num_iterations": 5, "seed": 4}}]}))
    assert cli.main(["train", "--engine-json", str(ej), "--device", "cpu"],
                    storage=st) == 0
    assert "Training completed" in capsys.readouterr().out
    qfile = tmp_path / "queries.jsonl"
    qfile.write_text('{"user": "u0", "num": 3}\n'
                     '{"user": "u1", "num": 2}\n')
    ofile = tmp_path / "out.jsonl"
    assert cli.main(["batchpredict", "--engine-json", str(ej), "--input",
                     str(qfile), "--output", str(ofile), "--device", "cpu"],
                    storage=st) == 0
    assert f"Wrote 2 prediction(s) to {ofile}." in capsys.readouterr().out
    lines = [json.loads(ln) for ln in ofile.read_text().splitlines()]
    assert len(lines) == 2
    assert len(lines[0]["prediction"]["itemScores"]) == 3
    # the batched answers are the single-query path's
    (inst,) = st.engine_instances().get_all()
    (model,) = loads_models(st.models().get(inst.id).models)
    algo = ALSAlgorithm(model.params)
    for line in lines:
        q = line["query"]
        want = algo.predict(model, Query(user=q["user"], num=q["num"]))
        got = line["prediction"]["itemScores"]
        assert [s["item"] for s in got] == [s.item for s in
                                            want.item_scores]
        np.testing.assert_allclose([s["score"] for s in got],
                                   [s.score for s in want.item_scores],
                                   rtol=1e-5)


def test_cli_batchpredict_runs_on_the_card_unless_asked(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    st = Storage(env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
    now = datetime.now(timezone.utc)
    inst_id = st.engine_instances().insert(EngineInstance(
        id="", status=STATUS_COMPLETED, start_time=now, end_time=now,
        engine_id="bp", engine_version="1",
        engine_variant=str(tmp_path / "engine.json"), engine_factory=""))
    rng = np.random.default_rng(0)
    st.models().insert(Model(id=inst_id, models=dumps_models([
        port_model((rng.standard_normal((N_USERS, RANK), np.float32),
                    rng.standard_normal((N_ITEMS, RANK), np.float32)))])))
    (tmp_path / "engine.json").write_text(json.dumps(VARIANT))
    (tmp_path / "q.jsonl").write_text('{"user": "u1"}\n')
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["batchpredict", "--engine-json",
                  str(tmp_path / "engine.json"), "--input",
                  str(tmp_path / "q.jsonl"), "--output",
                  str(tmp_path / "out.jsonl")], storage=st)
