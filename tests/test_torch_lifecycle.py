"""The ``pio`` lifecycle of the port end to end on the CPU, and its
training held to the JAX package's from one store.

``app new``, the event server on port 0, events over all three ingest
routes, ``train --device cpu`` through the CLI with the JAX package's
shipped ``engineFactory`` string, the storage-backed ``deploy --device
cpu``, and ``/queries.json`` answers equal to the plain top-k on the
stored model's tables (scores within 1e-5 relative, ids in the plain
ranking's order). The parity case reads one store with both packages'
data sources (identical ratings) and trains both from the JAX package's
own initial draw: the factors agree within rtol 2e-3, atol 2e-4, the
tolerance of ``tests/test_torch_als_training.py``.
"""

import json
import pickle
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import predictionio_tpu.data.columnar as jcol
import predictionio_tpu.data.event as jev
import predictionio_tpu.data.storage.wire as jwire
import predictionio_tpu.models.als as jals
import predictionio_tpu.templates.recommendation as jrec
from predictionio_tpu.controller.context import Context as JContext
from predictionio_tpu.data.storage.registry import Storage as JStorage
from predictionio_tpu_torch import cli
from predictionio_tpu_torch.controller.context import Context
from predictionio_tpu_torch.data.storage.base import STATUS_COMPLETED
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.models.convert import factors_to_numpy
from predictionio_tpu_torch.ops.fused_topk import fused_topk_reference
from predictionio_tpu_torch.templates import recommendation as prec
from predictionio_tpu_torch.workflow.persistence import loads_models

APP = "MyApp1"
JAX_FACTORY = "predictionio_tpu.templates.recommendation:recommendation_engine"
N_USERS, N_ITEMS, RANK = 40, 30, 8

#: loopback only: no proxy from the environment may carry these requests
_LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def call(port, method, path, body=None, raw=None):
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    try:
        with _LOCAL.open(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def rating_events(seed=0):
    """Every user rates a quarter of the items (at least 3), on
    half-star values; a few buys beside them."""
    rng = np.random.default_rng(seed)
    out = []
    for u in range(N_USERS):
        items = rng.choice(N_ITEMS, max(3, N_ITEMS // 4), replace=False)
        for k, i in enumerate(items):
            e = {"event": "rate", "entityType": "user", "entityId": f"u{u}",
                 "targetEntityType": "item", "targetEntityId": f"i{i}",
                 "properties": {"rating": float(rng.integers(1, 11)) / 2},
                 "eventTime": f"2024-01-01T00:{u % 60:02d}:{k:02d}.000Z"}
            if k == 0 and u % 7 == 0:
                e["event"] = "buy"
                del e["properties"]
            out.append(e)
    return out


def write_variant(tmp_path, factory=JAX_FACTORY, iters=3):
    path = tmp_path / "engine.json"
    path.write_text(json.dumps({
        "id": "recommendation", "version": "1", "engineFactory": factory,
        "datasource": {"params": {"app_name": APP}},
        "algorithms": [{"name": "als", "params": {
            "rank": RANK, "num_iterations": iters, "reg": 0.01,
            "seed": 3}}]}))
    return str(path)


def ingest(storage, events):
    """app new, then the events through the event server: a few single
    posts, batches of 50 and one npz column block."""
    assert cli.main(["app", "new", APP], storage=storage) == 0
    app = storage.apps().get_by_name(APP)
    key = storage.access_keys().get_by_app_id(app.id)[0].key
    args = cli._parser().parse_args(["eventserver", "--ip", "127.0.0.1",
                                     "--port", "0"])
    srv = cli.build_eventserver(args, storage).start_background()
    try:
        q = f"?accessKey={key}"
        for e in events[:5]:
            assert call(srv.port, "POST", f"/events.json{q}", e)[0] == 201
        rest, block = events[5:205], events[205:]
        for s in range(0, len(rest), 50):
            status, body = call(srv.port, "POST", f"/batch/events.json{q}",
                                rest[s:s + 50])
            assert status == 200 and {r["status"] for r in body} == {201}
        npz = jwire.batch_to_npz(jcol.columnar_from_events(
            jev.Event.from_json(e) for e in block))
        assert call(srv.port, "POST", f"/columnar/events.npz{q}",
                    raw=npz) == (201, {"accepted": len(block)})
        status, got = call(srv.port, "GET", f"/events.json{q}&entityType="
                           f"user&entityId=u3&limit=-1")
        assert status == 200
        sent = sorted(json.dumps({k: e[k] for k in ("event", "entityId",
                                                    "targetEntityId")})
                      for e in events if e["entityId"] == "u3")
        assert sorted(json.dumps({k: g[k] for k in (
            "event", "entityId", "targetEntityId")}) for g in got) == sent
    finally:
        srv.close()
    return app.id


@pytest.fixture()
def store(tmp_path):
    s = Storage(env={"PIO_HOME": str(tmp_path / "home")})
    yield s
    s.close()


def plain_answer(model, query):
    """The plain top-k on the stored model's tables, blacklist removed."""
    U, V = model.user_factors.float(), model.item_factors.float()
    uidx = model.user_ids[query["user"]]
    black = {model.item_ids[b] for b in query.get("blackList", [])}
    k = als._compiled_k(query["num"] + len(black), model.n_items)
    s, i = fused_topk_reference(U, torch.tensor([uidx], dtype=torch.int32),
                                V, k=k, n_items=model.n_items)
    inv = model.item_ids.inverse
    keep = [(inv[int(it)], float(sc)) for it, sc in zip(i[0], s[0])
            if int(it) not in black][: query["num"]]
    return keep


def test_lifecycle_end_to_end_on_cpu(store, tmp_path, capsys):
    events = rating_events()
    ingest(store, events)
    variant = write_variant(tmp_path)
    assert cli.main(["train", "--engine-json", variant, "--device", "cpu"],
                    storage=store) == 0
    out = capsys.readouterr().out
    assert "Training completed" in out and "persist_s" in out
    (inst,) = store.engine_instances().get_all()
    assert inst.status == STATUS_COMPLETED
    assert inst.engine_factory == JAX_FACTORY
    assert inst.engine_id == "recommendation"
    (model,) = loads_models(store.models().get(inst.id).models)
    assert model.params.rank == RANK
    assert model.n_users == N_USERS and model.n_items == N_ITEMS

    args = cli._parser().parse_args([
        "deploy", "--engine-json", variant, "--ip", "127.0.0.1", "--port",
        "0", "--device", "cpu", "--batching"])
    srv = cli.build_deploy(args, store).start_background()
    try:
        status, st = call(srv.port, "GET", "/status.json")
        assert st["engineInstanceId"] == inst.id and st["device"] == "cpu"
        queries = [{"user": f"u{u}", "num": 5} for u in range(0, 40, 3)]
        queries[0]["blackList"] = ["i1", "i2"]
        for q in queries:
            status, body = call(srv.port, "POST", "/queries.json", q)
            assert status == 200
            got = [(r["item"], r["score"]) for r in body["itemScores"]]
            want = plain_answer(model, q)
            assert [g[0] for g in got] == [w[0] for w in want]
            np.testing.assert_allclose([g[1] for g in got],
                                       [w[1] for w in want], rtol=1e-5)
        assert call(srv.port, "POST", "/queries.json",
                    {"user": "nobody", "num": 3}) == (200, {"itemScores": []})
    finally:
        srv.close()


def test_import_builds_the_sidecar(store, tmp_path, capsys):
    assert cli.main(["app", "new", APP], storage=store) == 0
    f = tmp_path / "events.jsonl"
    events = rating_events()[:60]
    f.write_text("\n".join(json.dumps(e) for e in events) + "\n")
    assert cli.main(["import", "--app", APP, "--input", str(f)],
                    storage=store) == 0
    out = capsys.readouterr().out
    assert "Imported 60 event(s)." in out and "sidecar ready" in out
    assert len(list(store.events().find(1))) == 60


def jax_init(params, jr):
    """The JAX package's initial draw, as its train_als makes it."""
    packed = jals.pack_ratings(jr, params)
    rows = [getattr(h, "n_rows_padded", None) or h.n_rows for h in packed]
    ku, ki = jax.random.split(jax.random.key(params.seed))
    U0 = jals._init_factors(ku, n=jr.n_users, n_padded=rows[0],
                            rank=params.rank)
    V0 = jals._init_factors(ki, n=jr.n_items, n_padded=rows[1],
                            rank=params.rank)
    return factors_to_numpy(U0, V0)


def test_both_packages_train_alike_from_one_store(store, tmp_path):
    ingest(store, rating_events(seed=1))
    jstore = JStorage(env={"PIO_HOME": str(tmp_path / "home")})
    try:
        jtd = jrec.RecommendationDataSource(jrec.DataSourceParams(
            app_name=APP)).read_training(JContext(_storage=jstore))
        ptd = prec.RecommendationDataSource(prec.DataSourceParams(
            app_name=APP)).read_training(Context(device="cpu",
                                                 _storage=store))
        for f in ("users", "items", "ratings"):
            np.testing.assert_array_equal(getattr(ptd.ratings, f),
                                          getattr(jtd.ratings, f))
        assert ptd.user_ids.to_dict() == jtd.user_ids.to_dict()
        assert ptd.item_ids.to_dict() == jtd.item_ids.to_dict()
        jp = jals.ALSParams(rank=RANK, num_iterations=3, seed=3, reg=0.01)
        pp = als.ALSParams(rank=RANK, num_iterations=3, seed=3, reg=0.01)
        jU, jV = jals.train_als(jtd.ratings, jp)
        U, V = als.train_als(ptd.ratings, pp, device="cpu",
                             init=jax_init(jp, jtd.ratings))
        np.testing.assert_allclose(U.numpy(), np.asarray(jU)[:N_USERS],
                                   rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(V.numpy(), np.asarray(jV)[:N_ITEMS],
                                   rtol=2e-3, atol=2e-4)
    finally:
        jstore.close()


def test_train_and_deploy_default_to_the_card(store, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ingest(store, rating_events()[:120])
    variant = write_variant(tmp_path, iters=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["train", "--engine-json", variant], storage=store)
    assert cli.main(["train", "--engine-json", variant, "--device", "cpu"],
                    storage=store) == 0
    args = cli._parser().parse_args(["deploy", "--engine-json", variant,
                                     "--ip", "127.0.0.1", "--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.build_deploy(args, store)


def test_run_train_and_deploy_functions_default_to_the_card(
        store, tmp_path, monkeypatch):
    """The functions behind the CLI, called directly: a context or a
    server config that names no device means the card, and raises where
    there is none; the event server needs no device at all."""
    from predictionio_tpu_torch.server import engineserver
    from predictionio_tpu_torch.workflow import core as wf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ingest(store, rating_events()[:120])  # the event server runs card-less
    with open(write_variant(tmp_path, iters=1)) as f:
        engine, ep = cli.engine_from_variant(json.load(f))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        wf.run_train(Context(_storage=store), engine, ep)
    inst = wf.run_train(Context(device="cpu", _storage=store), engine, ep)
    assert store.engine_instances().get(inst).status == STATUS_COMPLETED
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engineserver.deploy(Context(device="cpu", _storage=store), engine,
                            ep)
    srv = engineserver.deploy(
        Context(device="cpu", _storage=store), engine, ep,
        config=engineserver.ServerConfig(device="cpu"), host="127.0.0.1",
        port=0)
    srv.close()


def test_deploy_needs_a_completed_instance(store, tmp_path):
    variant = write_variant(tmp_path)
    args = cli._parser().parse_args(["deploy", "--engine-json", variant,
                                     "--device", "cpu", "--port", "0"])
    with pytest.raises(RuntimeError, match="run train first"):
        cli.build_deploy(args, store)


class _WritesAMarker:
    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return (open, (self.path, "w"))


def _jax_instance(store, tmp_path, blob):
    from predictionio_tpu_torch.data.event import utcnow
    from predictionio_tpu_torch.data.storage.base import (
        EngineInstance,
        Model,
    )

    store.engine_instances().insert(EngineInstance(
        id="j1", status=STATUS_COMPLETED, start_time=utcnow(),
        end_time=utcnow(), engine_id="recommendation", engine_version="1",
        engine_variant=write_variant(tmp_path), engine_factory=JAX_FACTORY))
    store.models().insert(Model("j1", blob))
    return cli._parser().parse_args([
        "deploy", "--engine-json", str(tmp_path / "engine.json"),
        "--device", "cpu", "--port", "0", "--ip", "127.0.0.1"])


def test_a_jax_written_model_blob_is_refused(store, tmp_path):
    """A blob in the JAX package's pickle format that names a global
    outside its model classes is refused before anything of it runs:
    the reduce that would create the marker file never runs."""
    marker = tmp_path / "marker"
    args = _jax_instance(store, tmp_path, pickle.dumps(
        [_WritesAMarker(str(marker))], protocol=4))
    with pytest.raises(ValueError, match="refused"):
        cli.build_deploy(args, store)
    assert not marker.exists()


def test_a_jax_written_model_blob_deploys(store, tmp_path):
    """The MODELDATA blob the JAX package writes (a pickle of its host
    ALSModel) deploys through the port's CLI, and answers as the
    JAX package's model does."""
    import predictionio_tpu.workflow.persistence as jpersistence

    rng = np.random.default_rng(5)
    U = rng.standard_normal((N_USERS, RANK)).astype(np.float32)
    V = rng.standard_normal((N_ITEMS, RANK)).astype(np.float32)
    from predictionio_tpu.data.bimap import BiMap as JBiMap

    jmodel = jals.ALSModel(
        U, V, N_USERS, N_ITEMS,
        JBiMap({f"u{i}": i for i in range(N_USERS)}),
        JBiMap({f"i{i}": i for i in range(N_ITEMS)}),
        params=jals.ALSParams(rank=RANK))
    args = _jax_instance(store, tmp_path,
                         jpersistence.dumps_models([jmodel]))
    srv = cli.build_deploy(args, store).start_background()
    try:
        query = {"user": "u3", "num": 5, "blackList": ["i2"]}
        code, body = call(srv.port, "POST", "/queries.json", query)
        assert code == 200
        (model,) = srv.query_server.models
        assert [s["item"] for s in body["itemScores"]] == [
            item for item, _ in plain_answer(model, query)]
        assert call(srv.port, "GET", "/status.json")[1][
            "engineInstanceId"] == "j1"
    finally:
        srv.close()


def test_a_factory_the_port_lacks_raises_the_jax_cli_error(tmp_path, store):
    # every shipped template is ported: aot is a JAX-package module the
    # port decides not to port (ROADMAP.md)
    variant = write_variant(
        tmp_path, factory="predictionio_tpu.aot:aot_engine")
    with pytest.raises(SystemExit, match="Cannot import engine factory "
                       "module 'predictionio_tpu_torch.aot'"):
        cli.main(["train", "--engine-json", variant, "--device", "cpu"],
                 storage=store)
    assert cli.port_module_name("predictionio_tpu") == "predictionio_tpu_torch"
    assert cli.port_module_name("predictionio_tpu_x.y") == \
        "predictionio_tpu_x.y"
