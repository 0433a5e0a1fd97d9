"""Mesh-wide serving of the port held to the JAX package's, on the CPU.

The JAX package runs on its 8 forced CPU devices (``tests/conftest.py``);
the port on 8 CPU devices from ``PTPU_TORCH_FORCE_DEVICE_COUNT=8`` (set
here with ``monkeypatch``). Each case of ``tests/test_mesh_serving.py``
that serves (``TestMeshPlumbing``, ``TestShardedServing``,
``TestReplicatedLanes``, ``TestQueryServerMeshModes``), the sharded cases
of ``tests/test_parallel.py``, the lane supervision of
``tests/test_reliability.py`` driven through the ``serving.lane`` faults
of a live server, and the fold-in into a row-sharded model run in both
packages on the same seeded numbers.

Tolerances: ids exactly everywhere (the f32, bf16 and int8 rankings, the
sharded and the single answers); scores bitwise between the port's
sharded and single paths, within ``SCORE_RTOL`` of the JAX package's
(f32 sums in another order); int8 tables bitwise; folded rows bitwise
between the port's sharded and single fold-ins (explicit feedback: the
same rows in the same order), within ``FOLD_RTOL`` / ``FOLD_ATOL`` of the
JAX package's and of the port's own single fold-in where an implicit
Gramian sums over shards.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import predictionio_tpu.models.als as jals
import predictionio_tpu.parallel as jpar
import predictionio_tpu.server.engineserver as jes
from predictionio_tpu.models.als import recommend_batch_sharded as jrbs
from test_mesh_serving import _mk_server as jax_server
from test_mesh_serving import _model as jax_model
from test_mesh_serving import _ratings
from test_torch_streaming import (  # noqa: F401 — a fixture
    _fold_both,
    _rate,
    both_models,
    shared_db,
)

from predictionio_tpu_torch import faults as pfaults
from predictionio_tpu_torch import parallel as ppar
from predictionio_tpu_torch.models import als as pals
from predictionio_tpu_torch.models.convert import (
    als_model_from_jax,
    als_model_from_numpy,
)
from predictionio_tpu_torch.server.engineserver import (
    QueryServer,
    ServerConfig,
    pick_live_lane,
)
from predictionio_tpu_torch.templates.recommendation import (
    recommendation_engine,
)

GiB = 1 << 30
#: the port's scores against the JAX package's (f32 sums in another order)
SCORE_RTOL = 1e-5
#: folded rows against the JAX package's, and an implicit fold-in's
#: against the port's single-table one (the Gramian sums over shards)
FOLD_RTOL, FOLD_ATOL = 1e-4, 1e-5
QUANTS = ("off", "bf16", "int8")


@pytest.fixture(autouse=True)
def eight_devices(monkeypatch):
    """The port's 8 devices; the JAX package's device path everywhere;
    no fault left armed in either package."""
    monkeypatch.setenv(ppar.FORCE_DEVICE_COUNT_ENV, "8")
    monkeypatch.setattr(jals, "HOST_SERVE_WORK", 0)
    assert len(jax.devices()) == 8
    yield
    pfaults.clear()


def cpu_devices():
    return ppar.local_devices("cpu")


def port_model(jm, quant="off"):
    """The port's model of the JAX test's ``_model`` numbers, quantized
    like the JAX package's (int8 tables bitwise equal)."""
    pm = als_model_from_numpy(
        jm.user_factors, jm.item_factors, jm.n_users, jm.n_items,
        dict(jm.user_ids.items()), dict(jm.item_ids.items()),
        {"rank": jm.params.rank}, device="cpu")
    if quant == "off":
        return pm
    return pals.quantize_serving_model(pm, quant)


def jax_quant(jm, quant):
    return jm if quant == "off" else jals.quantize_serving_model(jm, quant)


def items(answer):
    return [s["item"] for s in answer["itemScores"]]


@pytest.fixture
def servers():
    """Port servers made by a test, closed after it."""
    made = []

    def make(model, **cfg):
        engine = recommendation_engine()
        ep = engine.params_from_variant(
            {"algorithms": [{"name": "als",
                             "params": {"rank": model.params.rank}}]})
        qs = QueryServer(engine, ep, [model],
                         ServerConfig(device="cpu", warm_start=False,
                                      slo_interval_ms=0, **cfg))
        made.append(qs)
        return qs

    yield make
    for qs in made:
        qs.close()


# ---------------------------------------------------------------------------
# TestMeshPlumbing
# ---------------------------------------------------------------------------

def test_serving_mesh_axes_and_shape():
    jmesh, pmesh = jpar.make_serving_mesh(), ppar.make_serving_mesh(
        devices=cpu_devices())
    assert pmesh.axis_names == jmesh.axis_names == ("batch", "model")
    assert pmesh.size == jmesh.devices.size == len(cpu_devices()) == 8
    j2 = jpar.make_serving_mesh(batch=4, model=2)
    p2 = ppar.make_serving_mesh(batch=4, model=2, devices=cpu_devices())
    assert dict(zip(p2.axis_names, p2.shape)) \
        == dict(zip(j2.axis_names, j2.devices.shape)) \
        == {"batch": 4, "model": 2}
    with pytest.raises(ValueError):
        ppar.make_serving_mesh(batch=8, model=2, devices=cpu_devices())


def test_rows_spec_covers_every_axis():
    j2 = jpar.make_serving_mesh(batch=4, model=2)
    p2 = ppar.make_serving_mesh(batch=4, model=2, devices=cpu_devices())
    assert jpar.rows_spec(j2) == P(ppar.rows_spec(p2))
    assert ppar.rows_spec(p2) == ("batch", "model")
    assert jpar.rows_spec(None) == P(*ppar.rows_spec(None)) == P()
    assert ppar.pad_to_multiple(101, 8) == jpar.pad_to_multiple(101, 8) \
        == 104


@pytest.mark.parametrize("args,kw", [
    (("replicated", None, 8), {}),
    (("sharded", None, 8), {}),
    (("auto", None, 1), {}),
    (("auto", None, 8), {"hbm_limit": None}),
    (("auto", 1 * GiB, 8), {"hbm_limit": 16 * GiB}),
    (("auto", (10_000_000 + 100_000) * 256 * 4, 8), {"hbm_limit": 16 * GiB}),
    (("single", None, 8), {}),
], ids=["replicated", "sharded", "auto-one", "auto-unsized", "auto-fits",
        "auto-big", "single"])
def test_resolve_serving_mode(args, kw):
    assert ppar.resolve_serving_mode(*args, **kw) \
        == jpar.resolve_serving_mode(*args, **kw)


def test_resolve_serving_mode_refuses_an_unknown_mode():
    for resolve in (ppar.resolve_serving_mode, jpar.resolve_serving_mode):
        with pytest.raises(ValueError):
            resolve("bogus", None, 8)


def test_local_devices_is_off_by_default(monkeypatch):
    monkeypatch.delenv(ppar.FORCE_DEVICE_COUNT_ENV)
    assert [str(d) for d in ppar.local_devices("cpu")] == ["cpu"]
    assert ppar.device_hbm_bytes("cpu") is None
    monkeypatch.setenv(ppar.FORCE_DEVICE_COUNT_ENV, "3")
    assert [str(d) for d in ppar.local_devices("cpu")] == ["cpu"] * 3


# ---------------------------------------------------------------------------
# TestShardedServing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", QUANTS)
def test_shard_model_places_rows_on_every_device(quant):
    jm = jax_model()
    mesh = ppar.make_serving_mesh(devices=cpu_devices())
    ms = pals.shard_model(port_model(jm, quant), mesh)
    jms = jals.shard_model(jax_quant(jm, quant), jpar.make_serving_mesh())
    assert ms.mesh is mesh and len(ms.item_factors.shards) == 8
    jdata = getattr(jms.item_factors, "data", jms.item_factors)
    assert ms.item_factors.shape[0] == jdata.shape[0] == 104
    assert ms.n_items == jms.n_items == 101
    assert pals.table_quant(ms.item_factors) == quant
    # the padded, sharded tables hold the JAX package's values
    np.testing.assert_array_equal(pals.table_host_f32(ms.item_factors),
                                  jals.table_host_f32(jms.item_factors))
    if quant != "off":
        shard = ms.user_factors.shards[3]
        assert shard.quant == quant and shard.data.shape[0] == 25
        assert (shard.scale is None) == (quant == "bf16")


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("shape", [(4, 2), (8, 1)], ids=["4x2", "8x1"])
def test_sharded_predictions_match_single_device(quant, shape):
    jm = jax_model()
    pm = port_model(jm, quant)
    ms = pals.shard_model(pm, ppar.make_serving_mesh(
        *shape, devices=cpu_devices()))
    jms = jals.shard_model(jax_quant(jm, quant),
                           jpar.make_serving_mesh(*shape))
    idx = np.random.default_rng(2).integers(0, jm.n_users, 7)
    want_i, want_s = pals.recommend_batch(pm, idx, 10)
    ids, scores = pals.recommend_batch(ms, idx, 10)
    np.testing.assert_array_equal(ids, want_i)
    np.testing.assert_array_equal(scores, want_s)
    j_i, j_s = jals.recommend_batch(jms, idx, 10)
    np.testing.assert_array_equal(ids, np.asarray(j_i))
    np.testing.assert_allclose(scores, np.asarray(j_s), rtol=SCORE_RTOL)
    i1, s1 = pals.recommend_products(ms, int(idx[0]), 10)
    np.testing.assert_array_equal(i1, ids[0])


def test_sharded_k_exceeding_local_shard():
    # 104 padded items over 8 shards = 13 a shard; ask for 20
    jm = jax_model(ni=101)
    ms = pals.shard_model(port_model(jm),
                          ppar.make_serving_mesh(devices=cpu_devices()))
    jms = jals.shard_model(jm, jpar.make_serving_mesh())
    want_s, want_i = jals._serve_topk(
        jnp.asarray(jm.user_factors), jnp.asarray(jm.item_factors),
        np.asarray([3]), k=20, n_items=jm.n_items)
    ids, _ = pals.recommend_batch(ms, np.asarray([3]), 20)
    np.testing.assert_array_equal(ids[0], np.asarray(want_i)[0][:20])
    np.testing.assert_array_equal(
        ids, np.asarray(jals.recommend_batch(jms, np.asarray([3]), 20)[0]))


@pytest.mark.parametrize("k", [5, 200], ids=["kernel-k", "plain-k"])
def test_sharded_concurrent_dispatch_is_safe(k):
    ms = pals.shard_model(port_model(jax_model()),
                          ppar.make_serving_mesh(devices=cpu_devices()))
    want, _ = pals.recommend_batch(ms, np.asarray([1, 2, 3]), k)
    results = [None] * 8

    def fire(i):
        results[i] = pals.recommend_batch(ms, np.asarray([1, 2, 3]), k)[0]

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for got in results:
        np.testing.assert_array_equal(got, want)


def test_sharded_launches_one_kernel_call_a_shard(monkeypatch):
    """Each shard is one ``fused_topk`` call: the gathered user rows in
    the table's dtype with their scales, ``idx = arange(B)``, ``base`` at
    the shard's origin, ``k_local`` and the real ``n_items``."""
    pm = port_model(jax_model(), "int8")
    ms = pals.shard_model(pm, ppar.make_serving_mesh(devices=cpu_devices()))
    seen, real = [], pals.fused_topk

    def spy(ut, idx, vt, us=None, vs=None, base=None, **kw):
        seen.append((ut.dtype, us.shape, idx.tolist(), base, kw))
        return real(ut, idx, vt, us, vs, base, **kw)

    monkeypatch.setattr(pals, "fused_topk", spy)
    pals.recommend_batch(ms, np.asarray([4, 150, 9]), 10)
    assert [s[3] for s in seen] == [13 * s for s in range(8)]
    for dtype, us_shape, idx, _, kw in seen:
        assert dtype == pals.torch.int8 and us_shape == (3, 1)
        assert idx == [0, 1, 2]
        assert kw == {"k": 13, "n_items": 101}  # k_local = n_local


@pytest.mark.parametrize("quant", QUANTS)
def test_sharded_pinned_hot_rows(quant):
    jm = jax_model()
    ms = pals.shard_model(port_model(jm, quant),
                          ppar.make_serving_mesh(devices=cpu_devices()))
    pinned, nbytes = pals.pin_user_rows(ms, [5, 9], 4)
    assert pinned is not None and nbytes > 0
    want_i, want_s = pals.recommend_products(ms, 9, 10)
    ids, scores = pals.recommend_pinned(ms, pinned, 1, 10)
    np.testing.assert_array_equal(ids, want_i)
    np.testing.assert_array_equal(scores, want_s)
    jms = jals.shard_model(jax_quant(jm, quant), jpar.make_serving_mesh())
    jpinned, _ = jals.pin_user_rows(jms, [5, 9], 4)
    np.testing.assert_array_equal(
        ids, np.asarray(jals.recommend_pinned(jms, jpinned, 1, 10)[0]))


# -- tests/test_parallel.py --------------------------------------------------

def test_sharded_top_k():
    rng = np.random.default_rng(0)
    scores = rng.normal(size=64).astype(np.float32)
    jmesh = jpar.make_mesh(data=4, model=2)
    js = jax.device_put(scores, NamedSharding(jmesh, P("model")))
    j_idx, j_vals = jpar.sharded_top_k(js, k=5, mesh=jmesh)
    pmesh = ppar.make_serving_mesh(batch=4, model=2, devices=cpu_devices())
    idx, vals = ppar.sharded_top_k(pals.torch.from_numpy(scores), k=5,
                                   mesh=pmesh)
    want = np.argsort(-scores)[:5]
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(np.sort(idx.numpy()),
                                  np.sort(np.asarray(j_idx)))
    np.testing.assert_allclose(vals.numpy(), np.asarray(j_vals), rtol=1e-6)


@pytest.mark.parametrize("case", ["matches_single_device",
                                  "k_exceeding_local_shard"])
def test_recommend_batch_sharded_matches_jax(case):
    if case == "matches_single_device":
        shape, seed, n_items, n_pad, r, nu, k = (4, 2), 0, 101, 104, 16, 40, 10
    else:
        shape, seed, n_items, n_pad, r, nu, k = (8, 1), 1, 13, 16, 8, 5, 6
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((n_pad, r)).astype(np.float32)
    U = rng.standard_normal((nu, r)).astype(np.float32)
    idx = rng.integers(0, nu, 7) if seed == 0 else np.arange(nu)
    j_i, j_s = jrbs(U, V, idx, k, jpar.make_mesh(*shape), n_items)
    pmesh = ppar.make_serving_mesh(*shape, devices=cpu_devices())
    ids, scores = pals.recommend_batch_sharded(U, V, idx, k, pmesh, n_items)
    np.testing.assert_array_equal(ids, np.asarray(j_i))
    np.testing.assert_allclose(scores, np.asarray(j_s), rtol=SCORE_RTOL)
    with pytest.raises(ValueError, match="not divisible"):
        pals.recommend_batch_sharded(U, V[:-1], idx, k, pmesh, n_items)


# ---------------------------------------------------------------------------
# TestReplicatedLanes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", QUANTS)
def test_replicate_model_commits_to_device(quant):
    jm = jax_model()
    dev = cpu_devices()[3]
    mr = pals.replicate_model(port_model(jm, quant), dev)
    data = getattr(mr.user_factors, "data", mr.user_factors)
    assert data.device == dev and mr.mesh is None
    jr = jals.replicate_model(jm, jax.devices()[3])
    assert list(jr.user_factors.devices()) == [jax.devices()[3]]
    # a sharded model replicates whole
    ms = pals.shard_model(port_model(jm, quant),
                          ppar.make_serving_mesh(devices=cpu_devices()))
    back = pals.replicate_model(ms, dev)
    np.testing.assert_array_equal(
        pals.table_host_f32(back.item_factors)[:jm.n_items],
        pals.table_host_f32(mr.item_factors))


@pytest.mark.parametrize("quant", QUANTS)
def test_lane_pinned_tables_follow_lane_model_device(quant):
    jm = jax_model()
    devs = cpu_devices()[:4]
    lane_models = [pals.replicate_model(port_model(jm, quant), d)
                   for d in devs]
    tables, nbytes = pals.pin_user_rows_lanes(lane_models[0], [5, 9], 4,
                                              devs)
    assert tables is not None and len(tables) == 4 and nbytes > 0
    want_i, _ = pals.recommend_products(lane_models[0], 5, 10)
    for lm, dev, table in zip(lane_models, devs, tables):
        ids, _ = pals.recommend_pinned(lm, tables, 0, 10)
        np.testing.assert_array_equal(ids, want_i)
        assert getattr(table, "data", table).device == dev
    jdevs = jax.devices()[:4]
    jlanes = [jals.replicate_model(jax_quant(jm, quant), d) for d in jdevs]
    jtables, _ = jals.pin_user_rows_lanes(jlanes[0], [5, 9], 4, jdevs)
    np.testing.assert_array_equal(
        want_i, np.asarray(jals.recommend_pinned(jlanes[2], jtables, 0,
                                                 10)[0]))
    assert pals.pin_user_rows_lanes(lane_models[0], [], 4, devs) \
        == (None, 0)


# ---------------------------------------------------------------------------
# TestQueryServerMeshModes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipeline", ["staged", "serial"])
def test_replicated_lanes_answer_identically(servers, pipeline):
    jm = jax_model(nu=300, ni=150)
    want = jax_server(jes.ServerConfig(warm_start=False),
                      jm).query({"user": "u7", "num": 5})
    qs = servers(port_model(jm), serving_mode="replicated", batching=True,
                 max_batch=8, serving_pipeline=pipeline)
    assert qs.serving_mode_resolved == "replicated"
    assert len(qs.lane_models) == 8
    assert qs.batcher is not None and qs.batcher.lanes == 8
    outs = [qs.query_batch([{"user": "u7", "num": 5}], lane=lane)[0]
            for lane in range(8)]
    assert all(o == outs[0] for o in outs)
    assert items(outs[0]) == items(want)
    # the serve() entry (what /queries.json calls) rides the lanes
    assert items(qs.serve({"user": "u7", "num": 5})) == items(want)


def test_replicated_without_batching_still_fans_out(servers):
    qs = servers(port_model(jax_model()), serving_mode="replicated")
    jqs = jax_server(jes.ServerConfig(warm_start=False,
                                      serving_mode="replicated"),
                     jax_model())
    assert qs.batcher is not None and qs.batcher.lanes == 8
    assert type(qs.batcher).__name__ == type(jqs.batcher).__name__


def test_replicated_mesh_status_and_metrics(servers):
    jm = jax_model(nu=300, ni=150)
    qs = servers(port_model(jm), serving_mode="replicated", batching=True,
                 max_batch=8)
    jqs = jax_server(jes.ServerConfig(warm_start=False,
                                      serving_mode="replicated",
                                      batching=True, max_batch=8), jm)
    for lane in range(3):
        qs.query_batch([{"user": "u1", "num": 3}], lane=lane)
        jqs.query_batch([{"user": "u1", "num": 3}], lane=lane)
    mesh, jmesh = qs.mesh_status(), jqs.mesh_status()
    assert mesh["mode"] == jmesh["mode"] == "replicated"
    assert mesh["devices"] == jmesh["devices"] == 8
    assert len(mesh["lanes"]) == 8
    assert set(mesh["lanes"][0]) == set(jmesh["lanes"][0])
    assert [lane["dispatches"] for lane in mesh["lanes"]] \
        == [lane["dispatches"] for lane in jmesh["lanes"]] \
        == [1, 1, 1, 0, 0, 0, 0, 0]
    text = qs.metrics.render()
    for fam in ("pio_lane_dispatches_total", "pio_serving_lanes",
                "pio_lane_batch_seconds", "pio_serving_degraded"):
        assert fam in text
    assert sample(qs, "pio_serving_lanes") == 8.0
    assert qs.status()["mesh"] == mesh


def test_lane_families_match_the_jax_packages(servers):
    """The seven lane families carry the JAX package's names, kinds and
    help."""
    qs = servers(port_model(jax_model()), serving_mode="replicated")
    jqs = jax_server(jes.ServerConfig(warm_start=False,
                                      serving_mode="replicated"),
                     jax_model())
    fams = ("pio_lane_batch_seconds", "pio_lane_queue_depth",
            "pio_lane_dispatches_total", "pio_lane_restarts_total",
            "pio_lane_failures_total", "pio_serving_lanes",
            "pio_serving_degraded")

    def heads(text):
        return {ln.split()[2]: ln for ln in text.splitlines()
                if ln.startswith(("# TYPE ", "# HELP "))
                and ln.split()[2] in fams and ln.startswith("# TYPE ")}

    def helps(text):
        return {ln.split()[2]: ln for ln in text.splitlines()
                if ln.startswith("# HELP ") and ln.split()[2] in fams}

    ptext, jtext = qs.metrics.render(), jqs.metrics.render()
    assert set(heads(ptext)) == set(fams)
    assert heads(ptext) == heads(jtext)
    assert helps(ptext) == helps(jtext)


def test_sharded_server_matches_single(servers):
    jm = jax_model(nu=300, ni=150)
    want = jax_server(jes.ServerConfig(warm_start=False),
                      jm).query({"user": "u7", "num": 5})
    qs = servers(port_model(jm), serving_mode="sharded")
    assert qs.serving_mode_resolved == "sharded"
    assert qs.serving_mesh is not None
    assert items(qs.query({"user": "u7", "num": 5})) == items(want)
    jqs = jax_server(jes.ServerConfig(warm_start=False,
                                      serving_mode="sharded"), jm)
    mesh = qs.mesh_status()
    assert mesh == jqs.mesh_status()
    assert mesh["meshShape"] == {"batch": 8, "model": 1}


def test_auto_resolves_replicated_on_unsized_backend(servers):
    # the CPU reports no memory limit: auto stays conservative, fan-out
    qs = servers(port_model(jax_model()), serving_mode="auto")
    jqs = jax_server(jes.ServerConfig(warm_start=False, serving_mode="auto"),
                     jax_model())
    assert qs.serving_mode_resolved == jqs.serving_mode_resolved \
        == "replicated"


@pytest.mark.parametrize("mode,want", [("single", "single"),
                                       ("auto", "single"),
                                       ("replicated", "single"),
                                       ("sharded", "sharded")])
def test_one_device_resolves_as_the_jax_package_on_one_chip(
        servers, monkeypatch, mode, want):
    monkeypatch.setenv(ppar.FORCE_DEVICE_COUNT_ENV, "1")
    qs = servers(port_model(jax_model()), serving_mode=mode)
    assert qs.serving_mode_resolved == want
    assert qs.lane_models == []
    if want == "sharded":
        assert qs.mesh_status()["meshShape"] == {"batch": 1, "model": 1}


def test_single_mode_is_unchanged(servers):
    qs = servers(port_model(jax_model()))
    jqs = jax_server(jes.ServerConfig(warm_start=False), jax_model())
    assert qs.serving_mode_resolved == jqs.serving_mode_resolved == "single"
    assert qs.lane_models == [] and qs.batcher is None
    assert qs.mesh_status() == jqs.mesh_status() == {"mode": "single"}
    with pytest.raises(ValueError, match="serving_mode"):
        servers(port_model(jax_model()), serving_mode="bogus")


def test_sharded_end_to_end_train_deploy_query(servers):
    """ALS trains over the JAX package's serving mesh; the port deploys
    those factors sharded and answers as a single-device JAX server."""
    r = _ratings(nu=120, ni=60, nnz=3000, seed=5)
    p = jals.ALSParams(rank=8, num_iterations=2, seed=3)
    U, V = jals.train_als(r, p, mesh=jpar.make_serving_mesh())
    jm = jals.ALSModel(
        user_factors=np.asarray(U)[:r.n_users],
        item_factors=np.asarray(V)[:r.n_items],
        n_users=r.n_users, n_items=r.n_items,
        user_ids=jax_model().user_ids.__class__(
            {f"u{i}": i for i in range(r.n_users)}),
        item_ids=jax_model().item_ids.__class__(
            {f"i{i}": i for i in range(r.n_items)}),
        params=p)
    want = jax_server(jes.ServerConfig(warm_start=False),
                      jm).query({"user": "u11", "num": 4})
    qs = servers(port_model(jm), serving_mode="sharded")
    assert items(qs.query({"user": "u11", "num": 4})) == items(want)
    assert qs.status()["mesh"]["mode"] == "sharded"


@pytest.mark.parametrize("quant", QUANTS)
def test_a_jax_sharded_model_converts(quant):
    """A JAX model the JAX package sharded converts: leaves read back,
    padding dropped, split again by the port."""
    jms = jals.shard_model(jax_quant(jax_model(), quant),
                           jpar.make_serving_mesh())
    mesh = ppar.make_serving_mesh(devices=cpu_devices())
    pm = als_model_from_jax(jms, device="cpu", mesh=mesh)
    assert pm.mesh is mesh and pm.n_items == 101
    assert pals.table_quant(pm.item_factors) == quant
    np.testing.assert_array_equal(
        pals.table_host_f32(pm.item_factors),
        jals.table_host_f32(jms.item_factors))
    idx = np.arange(0, 200, 17)
    np.testing.assert_array_equal(
        pals.recommend_batch(pm, idx, 10)[0],
        np.asarray(jals.recommend_batch(jms, idx, 10)[0]))


# ---------------------------------------------------------------------------
# lane supervision (tests/test_reliability.py), through serving.lane faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lane,n,dead,want", [
    (1, 4, set(), 1), (1, 4, {1}, 2), (3, 4, {3}, 0), (2, 3, {0, 1, 2}, 2),
    (0, 0, set(), 0)])
def test_pick_live_lane(lane, n, dead, want):
    assert pick_live_lane(lane, n, dead) \
        == jes.pick_live_lane(lane, n, dead) == want


def sample(qs, line_start):
    """The value of the one ``/metrics`` sample line that starts with
    ``line_start`` (the name and labels; never a HELP line)."""
    (value,) = [ln.rsplit(" ", 1)[1] for ln in qs.metrics.render().splitlines()
                if ln.startswith(line_start + " ")]
    return float(value)


def lane_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("lane-restarter")]


def burst(qs, n=64):
    """``n`` concurrent queries through the batch path; their answers."""
    out = [None] * n

    def one(i):
        out[i] = qs.serve({"user": f"u{i % 200}", "num": 5})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


@pytest.mark.parametrize("pipeline", ["staged", "serial"])
def test_a_killed_lane_fails_over_degrades_and_restarts(servers, pipeline):
    """Lane 1 fails ``lane_fail_threshold`` dispatches: each fails over
    (no query fails), then the lane is dead (degraded, its traffic on the
    survivors) while the restart probes fail, then it rejoins."""
    pm = port_model(jax_model())
    single = servers(pm)
    qs = servers(pm, serving_mode="replicated", batching=True, max_batch=4,
                 serving_pipeline=pipeline, lane_fail_threshold=2,
                 lane_restart_backoff_ms=5.0, lane_restart_max_attempts=50)
    pfaults.inject_spec("serving.lane=error,lane=1,times=2;"
                        "serving.lane_restart=error,lane=1,times=400")
    deadline = time.monotonic() + 30
    while not qs.degraded_status()["deadLanes"]:
        answers = burst(qs)
        assert all(items(a) == items(single.query(
            {"user": f"u{i % 200}", "num": 5}))
            for i, a in enumerate(answers))
        assert time.monotonic() < deadline, "lane 1 never died"
    st = qs.degraded_status()
    assert st["active"] and [d["lane"] for d in st["deadLanes"]] == [1]
    assert st["laneFailures"] == 2 and st["laneRestarts"] == 0
    assert sample(qs, "pio_serving_degraded") == 1.0
    assert qs.live_lane(1) != 1
    order = qs.lane_attempt_order(1)
    assert order[0] != 1 and order[-1] == 1 and sorted(order) == list(
        range(8))
    before = qs.mesh_status()["lanes"][1]["dispatches"]
    burst(qs)  # the dead lane takes nothing
    assert qs.mesh_status()["lanes"][1]["dispatches"] == before
    assert qs.query_errors == {}
    pfaults.clear()  # the next restart probe passes
    while qs.degraded_status()["active"]:
        assert time.monotonic() < deadline, "lane 1 never rejoined"
        time.sleep(0.01)
    st = qs.degraded_status()
    assert st["laneRestarts"] == 1 and st["deadLanes"] == []
    assert sample(qs, 'pio_lane_restarts_total{lane="1"}') == 1.0
    assert sample(qs, "pio_serving_degraded") == 0.0
    burst(qs, 256)
    assert qs.mesh_status()["lanes"][1]["dispatches"] > before


@pytest.mark.parametrize("threshold", [2, 3])
def test_a_streak_below_the_threshold_stays_alive(servers, threshold):
    qs = servers(port_model(jax_model()), serving_mode="replicated",
                 lane_fail_threshold=threshold)
    for _ in range(threshold - 1):
        qs._lane_error(1, RuntimeError("x"))
    assert not qs.degraded_status()["active"]
    qs._lane_ok(1)  # a success resets the streak
    for _ in range(threshold - 1):
        qs._lane_error(1, RuntimeError("x"))
    assert not qs.degraded_status()["active"]
    assert qs.degraded_status()["laneFailures"] == 2 * (threshold - 1)


def test_close_joins_a_restarter_in_its_backoff(servers):
    """The JAX package's restarter is a daemon thread nobody joins; the
    port's ``close()`` cuts its backoff short and joins it."""
    qs = servers(port_model(jax_model()), serving_mode="replicated",
                 lane_fail_threshold=1, lane_restart_backoff_ms=60_000.0)
    qs._lane_error(2, RuntimeError("dead device"))
    assert lane_threads() == ["lane-restarter-2"]
    t0 = time.monotonic()
    qs.close()
    assert lane_threads() == [] and time.monotonic() - t0 < 5.0


def test_a_rebind_resets_lane_health(servers):
    qs = servers(port_model(jax_model()), serving_mode="replicated",
                 lane_fail_threshold=1, lane_restart_backoff_ms=60_000.0)
    qs._lane_error(3, RuntimeError("x"))
    assert qs.degraded_status()["active"]
    qs._bind(qs.engine_params, [port_model(jax_model())])
    assert not qs.degraded_status()["active"]
    assert len(qs.lane_models) == 8


# ---------------------------------------------------------------------------
# the fold-in into a row-sharded model
# ---------------------------------------------------------------------------

def fold_histories(B=6, L=9, n_cols=20, seed=1):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_cols, (B, L)).astype(np.int32)
    val = (rng.random((B, L)) * 4 + 1).astype(np.float32)
    cnt = rng.integers(0, L + 1, B).astype(np.int32)
    cnt[2] = 0
    return idx, val, cnt


@pytest.mark.parametrize("quant,implicit", [("off", False), ("off", True),
                                            ("int8", False), ("int8", True)])
def test_sharded_fold_in_matches_jax(quant, implicit):
    jm, pm = both_models(implicit=implicit, quant=quant)
    jmesh = jpar.make_serving_mesh()
    jms = jals.shard_model(jm, jmesh)
    ms = pals.shard_model(pm, ppar.make_serving_mesh(devices=cpu_devices()))
    idx, val, cnt = fold_histories()
    single = pals.fold_in_rows(pm.item_factors, idx, val, cnt, pm.params)
    G = pals.fixed_gramian(ms.item_factors, pm.params)
    rows = pals.fold_in_rows(ms.item_factors, idx, val, cnt, pm.params)
    with_g = pals.fold_in_rows(ms.item_factors, idx, val, cnt, pm.params,
                               G=G)
    np.testing.assert_array_equal(rows, with_g)
    if implicit:
        np.testing.assert_allclose(rows, single, rtol=FOLD_RTOL,
                                   atol=FOLD_ATOL)
    else:
        np.testing.assert_array_equal(rows, single)
    jrows = jals.fold_in_rows(jms.item_factors, idx, val, cnt, jm.params)
    np.testing.assert_allclose(rows, jrows, rtol=FOLD_RTOL, atol=FOLD_ATOL)
    # the solved rows scatter into their owner shards, int8 bitwise
    touched = np.array([0, 4, 12])
    new = pals.apply_row_updates(ms, "user", touched, rows[:3])
    jnew = jals.apply_row_updates(jms, "user", touched, rows[:3])
    assert new.mesh is ms.mesh
    np.testing.assert_array_equal(pals.table_host_f32(new.user_factors),
                                  jals.table_host_f32(jnew.user_factors))
    owners = {int(t) // new.user_factors.n_local for t in touched}
    for s, (a, b) in enumerate(zip(ms.user_factors.shards,
                                   new.user_factors.shards)):
        assert (a is b) == (s not in owners)


@pytest.mark.parametrize("quant", ["off", "int8"])
def test_sharded_extend_claims_padding_then_grows_like_jax(quant):
    jm, pm = both_models(quant=quant)
    jms = jals.shard_model(jm, jpar.make_serving_mesh())
    ms = pals.shard_model(pm, ppar.make_serving_mesh(devices=cpu_devices()))
    rows = np.random.default_rng(3).normal(size=(40, 8)).astype(np.float32)
    for n in (3, 40):
        keys = [f"new{n}_{i}" for i in range(n)]
        ms = pals.extend_factor_rows(ms, "item", keys, rows[:n])
        jms = jals.extend_factor_rows(jms, "item", keys, rows[:n])
        assert ms.n_items == jms.n_items
        assert ms.item_factors.shape[0] % 8 == 0
        n_real = ms.n_items
        np.testing.assert_array_equal(
            pals.table_host_f32(ms.item_factors)[:n_real],
            jals.table_host_f32(jms.item_factors)[:n_real])
        idx = np.arange(10)
        np.testing.assert_array_equal(
            pals.recommend_batch(ms, idx, 8)[0],
            np.asarray(jals.recommend_batch(jms, idx, 8)[0]))


@pytest.mark.parametrize("quant,implicit", [("off", False), ("int8", True)],
                         ids=["f32-explicit", "int8-implicit"])
def test_fold_in_events_into_a_sharded_model_matches_jax(shared_db, quant,
                                                         implicit):
    """``fold_in_events`` (the stream trainer's pass) on a sharded model:
    the report and rows of the single-table fold-in and of the JAX
    package's."""
    from predictionio_tpu_torch.streaming import fold_in_events

    st, _, app_id, t = shared_db
    events = [_rate("u0", "i1", 5.0, t), _rate("u3", "i20", 2.0, t),
              _rate("u31", "i2", 4.0, t), _rate("u5", "i40", 3.0, t)]
    jout, jrep, pout, prep, pm = _fold_both(shared_db, events, quant,
                                            implicit)
    ms = pals.shard_model(pm, ppar.make_serving_mesh(devices=cpu_devices()))
    sout, srep = fold_in_events(ms, events, st, app_id)
    for f in ("events_relevant", "users_updated", "users_inserted",
              "items_inserted"):
        assert getattr(srep, f) == getattr(prep, f) == getattr(jrep, f), f
    assert sout.mesh is ms.mesh
    n_u = sout.n_users
    np.testing.assert_allclose(
        pals.table_host_f32(sout.user_factors)[:n_u],
        pals.table_host_f32(pout.user_factors)[:n_u], rtol=FOLD_RTOL,
        atol=FOLD_ATOL)
    np.testing.assert_allclose(
        pals.table_host_f32(sout.user_factors)[:n_u],
        jals.table_host_f32(jout.user_factors)[:n_u], rtol=FOLD_RTOL,
        atol=FOLD_ATOL)


def test_a_sharded_stream_delta_hot_swaps_and_replicas_follow(servers):
    """``apply_stream_delta``: a sharded binding takes the folded sharded
    model; a replicated binding's lanes each take a copy of it."""
    jm = jax_model()
    pm = port_model(jm)
    for mode in ("sharded", "replicated"):
        qs = servers(pm, serving_mode=mode)
        _, base = qs.stream_snapshot()
        rows = np.ones((2, base.params.rank), np.float32)
        new = pals.apply_row_updates(base, "user", np.array([7, 150]), rows)
        assert qs.apply_stream_delta(0, new, ["u7"], qs.binding_id, 2)
        assert qs.models[0] is new
        for lane in qs.lane_models:
            np.testing.assert_array_equal(
                pals.table_host_f32(lane[0].user_factors)[[7, 150]], rows)
        want = pals.recommend_products(new, 7, 5)[0]
        got = qs.query({"user": "u7", "num": 5})
        assert items(got) == [f"i{i}" for i in want]
        assert not qs.apply_stream_delta(0, new, [], "stale-binding")


# ---------------------------------------------------------------------------
# the command line: deploy --serving-mode, status's mesh block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,lanes", [("replicated", 8), ("sharded", 0),
                                        ("single", 0)])
def test_deploy_serving_mode_takes_effect_and_status_shows_the_mesh(
        tmp_path, capsys, mode, lanes):
    import json

    from predictionio_tpu_torch import cli
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.workflow.persistence import dumps_models

    variant = tmp_path / "engine.json"
    variant.write_text(json.dumps({
        "id": "mesh", "version": "1",
        "engineFactory": "predictionio_tpu_torch.templates."
                         "recommendation:recommendation_engine",
        "algorithms": [{"name": "als", "params": {"rank": 16}}]}))
    blob = tmp_path / "model.bin"
    blob.write_bytes(dumps_models([port_model(jax_model())]))
    args = cli._parser().parse_args([
        "deploy", "--engine-json", str(variant), "--model", str(blob),
        "--device", "cpu", "--ip", "127.0.0.1", "--port", "0",
        "--serving-mode", mode, "--slo-interval-ms", "0"])
    srv = cli.build_deploy(args).start_background()
    try:
        qs = srv.query_server
        assert qs.config.serving_mode == mode
        assert qs.serving_mode_resolved == mode
        assert len(qs.lane_models) == lanes
        capsys.readouterr()
        store = Storage(env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
        assert cli.main(["status", "--device", "cpu", "--ip", "127.0.0.1",
                         "--port", str(srv.port)], storage=store) == 0
        out = capsys.readouterr().out
        assert f"Mesh: mode {mode}" in out
        assert out.count("  lane ") == lanes
        if mode == "sharded":
            assert "mesh batch=8 x model=1, 8 device(s)" in out
    finally:
        srv.close()
    assert cli._parser().parse_args(
        ["build", "--serving-mode", mode]).serving_mode == mode
