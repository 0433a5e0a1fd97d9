"""ALS over a mesh in one process: the port's ``train_als(mesh=)`` against
the JAX package's ``train_als(mesh=mesh8)`` and against the port's own
single-device run.

The port's mesh is 8 CPU shards (``PTPU_TORCH_FORCE_DEVICE_COUNT=8``, set
here with ``monkeypatch``) laid out as the conftest's ``mesh8`` (4 x 2).
The JAX package draws its initial factors with ``jax.random``; the port
takes that draw as ``init=``, so both start from the same tables
(``tests/test_mesh_serving.py::TestTrainOverServingMesh`` is the JAX
package's own mesh-against-meshless oracle). Tolerances: against the JAX
package rtol 2e-3, atol 2e-4 (the port's single-device parity tolerance,
``tests/test_torch_als_training.py``); against the port's single device,
explicit feedback bit for bit (each row's system is built and solved
alike whatever the shard) and implicit within 1e-5 (1 + |x|) (the
Gramian's shard-order sum rounds apart). The e-commerce and
similar-product templates train through ``Engine.train`` over the
context's mesh of 2 and 4 shards, held to their one-device training
(from the JAX package's draw) within 1e-5 (1 + |x|) and bit for bit (the
port takes the implicit Gramian over the whole fixed side on every
device, as the single device does), and to the JAX package's templates
over ``mesh8`` at rtol 2e-3, atol 2e-4."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import predictionio_tpu.models.als as jals
from test_mesh_serving import _ratings
from predictionio_tpu_torch import parallel as ppar
from predictionio_tpu_torch.controller.context import Context
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.models import als as pals
from predictionio_tpu_torch.workflow import checkpoint as pckpt

LAYOUTS = ["pad", "bucket"]


@pytest.fixture(autouse=True)
def eight_shards(monkeypatch):
    monkeypatch.setenv(ppar.FORCE_DEVICE_COUNT_ENV, "8")
    monkeypatch.delenv("PTPU_DIST_CKPT", raising=False)


def mesh_of(data, model=1):
    return ppar.make_mesh(data=data, model=model,
                          devices=ppar.local_devices("cpu"))


def port_ratings(jr):
    return pals.RatingsCOO(np.asarray(jr.users), np.asarray(jr.items),
                           np.asarray(jr.ratings), jr.n_users, jr.n_items)


def jax_draw(seed, n_users, n_items, rank):
    ku, ki = jax.random.split(jax.random.key(seed))
    return tuple(np.array(jals._init_factors(k, n=n, n_padded=n, rank=rank))
                 for k, n in ((ku, n_users), (ki, n_items)))


def whole(t, n):
    return pals.unshard_table(t)[:n].numpy()


def params(implicit, layout, **kw):
    base = dict(rank=8, num_iterations=3, seed=3, implicit_prefs=implicit,
                alpha=4.0, history_mode=layout)
    base.update(kw)
    return base


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("implicit", [False, True],
                         ids=["explicit", "implicit"])
def test_matches_the_jax_mesh_training(mesh8, implicit, layout):
    jr = _ratings(seed=1)
    p = params(implicit, layout)
    Uj, Vj = jals.train_als(jr, jals.ALSParams(**p), mesh=mesh8)
    mesh = mesh_of(4, 2)
    U, V = pals.train_als(port_ratings(jr), pals.ALSParams(**p), mesh=mesh,
                          init=jax_draw(3, jr.n_users, jr.n_items, 8))
    assert isinstance(U, pals.RowShardedTable) and U.mesh is mesh
    assert len(U.shards) == 8 and U.shape[0] % 8 == 0
    assert tuple(np.asarray(Uj).shape) == U.shape
    np.testing.assert_allclose(whole(U, jr.n_users),
                               np.asarray(Uj)[:jr.n_users], rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(whole(V, jr.n_items),
                               np.asarray(Vj)[:jr.n_items], rtol=2e-3,
                               atol=2e-4)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shards", [(8, 1), (4, 2), (3, 1)], ids=str)
@pytest.mark.parametrize("implicit", [False, True],
                         ids=["explicit", "implicit"])
def test_a_mesh_run_is_the_single_device_run(implicit, shards, layout):
    jr = _ratings(seed=2)
    r = port_ratings(jr)
    p = pals.ALSParams(**params(implicit, layout, block_rows=7))
    U1, V1 = pals.train_als(r, p, device="cpu")
    U, V = pals.train_als(r, p, mesh=mesh_of(*shards))
    for got, want, n in ((U, U1, r.n_users), (V, V1, r.n_items)):
        g, w = whole(got, n), want[:n].numpy()
        if implicit:
            assert np.all(np.abs(g - w) <= 1e-5 * (1 + np.abs(w)))
        else:
            np.testing.assert_array_equal(g, w)


def test_each_piece_is_planned_as_the_single_devices_block():
    jr = _ratings(seed=2)
    r = port_ratings(jr)
    p = pals.ALSParams(**params(False, "pad", block_rows=7))
    packed = pals.pack_ratings(r, p, mesh=mesh_of(8))
    side = packed.mesh_side("user", p)
    # 96 users over 8 positions of 12 rows; the one device cuts blocks of
    # 7 rows (the last of 96 - 13 * 7 = 5)
    plans, starts = [], []
    for k, pieces in enumerate(side.pieces):
        for pc in pieces:
            plans.append(pc.plan_rows)
            starts.append(k * 12 + pc.offset)
    for start, plan in zip(starts, plans):
        j = start // 7
        assert plan == min(7, 96 - j * 7)
    assert side.launches == len(plans) and side.n_rows_padded == 96


@pytest.mark.parametrize("layout", LAYOUTS)
def test_each_positions_pieces_launch_every_rated_row_once(layout):
    jr = _ratings(seed=2)
    r = port_ratings(jr)
    p = pals.ALSParams(**params(False, layout, block_rows=7))
    packed = pals.pack_ratings(r, p, mesh=mesh_of(8))
    side = packed.mesh_side("user", p)
    assert len(side.pieces) == 8
    n_launch, n_rated = 0, 0
    for pieces in side.pieces:
        # a position's pieces tile its output rows in order, 7 at most
        end = None
        for pc in pieces:
            b = pc.indices.shape[0]
            assert 0 < b <= 7 and pc.values.shape[0] == pc.counts.shape[0]
            assert pc.counts.shape[0] == b and pc.plan_rows >= 1
            assert end is None or pc.offset >= end
            assert pc.offset + b <= side.block_rows_out
            end = pc.offset + b
            n_launch += 1
            n_rated += int((pc.counts > 0).sum())
    assert side.launches == n_launch
    assert n_rated == len(np.unique(r.users))


def test_the_plain_version_stands_in_for_the_kernel_over_a_mesh(
        monkeypatch):
    # a plain training run swaps fused_gram for its reference: the mesh's
    # planned launches must reach it with the same arguments
    from predictionio_tpu_torch.ops import fused_gram as fg

    jr = _ratings(seed=2)
    r = port_ratings(jr)
    p = pals.ALSParams(**params(False, "bucket", block_rows=7,
                                gram_mode="fused"))
    U, V = pals.train_als(r, p, mesh=mesh_of(4))
    monkeypatch.setattr(pals, "fused_gram", fg.fused_gram_reference)
    Up, Vp = pals.train_als(r, p, mesh=mesh_of(4))
    np.testing.assert_array_equal(whole(Up, r.n_users), whole(U, r.n_users))
    np.testing.assert_array_equal(whole(Vp, r.n_items), whole(V, r.n_items))


@pytest.mark.parametrize("dist", ["0", "1"], ids=["single", "distributed"])
def test_a_checkpointed_mesh_run_resumes_bitwise(tmp_path, monkeypatch,
                                                 dist):
    monkeypatch.setenv("PTPU_DIST_CKPT", dist)
    jr = _ratings(seed=3)
    r = port_ratings(jr)
    mesh = mesh_of(4, 2)
    p = pals.ALSParams(**params(False, "bucket", num_iterations=4))
    U, V = pals.train_als(r, p, mesh=mesh)
    ck = str(tmp_path / "ck")
    pals.train_als(r, dataclasses.replace(p, num_iterations=2), mesh=mesh,
                   checkpoint_dir=ck)
    kind = pckpt.DistributedCheckpointer if dist == "1" \
        else pckpt.Checkpointer
    assert isinstance(pckpt.make_checkpointer(ck), kind)
    Ur, Vr = pals.train_als(r, p, mesh=mesh, checkpoint_dir=ck)
    np.testing.assert_array_equal(whole(Ur, r.n_users), whole(U, r.n_users))
    np.testing.assert_array_equal(whole(Vr, r.n_items), whole(V, r.n_items))
    assert pckpt.make_checkpointer(ck).latest_step() == 4


def skewed_ratings(seed=4):
    """``_ratings`` plus two heavy users and a heavy item, so that the
    split layout's real rows run to many virtual rows."""
    jr = _ratings(seed=seed)
    rng = np.random.default_rng(seed)
    heavy_u = np.repeat(np.array([3, 40], np.int32), 30)
    heavy_i = rng.integers(0, jr.n_items, 60).astype(np.int32)
    more_u = rng.integers(0, jr.n_users, 40).astype(np.int32)
    users = np.concatenate([np.asarray(jr.users), heavy_u, more_u])
    items = np.concatenate([np.asarray(jr.items), heavy_i,
                            np.full(40, 5, np.int32)])
    users, items = pals.dedupe_pairs(users, items,
                                     np.ones(len(users), np.float32))[:2]
    vals = (rng.random(len(users)) * 4 + 1).astype(np.float32)
    return pals.RatingsCOO(users, items, vals, jr.n_users, jr.n_items)


SPLIT = dict(rank=6, num_iterations=3, seed=3, alpha=2.0,
             history_mode="split", max_history=4, block_rows=5)


@pytest.mark.parametrize("shards", [4, 8])
@pytest.mark.parametrize("implicit", [False, True],
                         ids=["explicit", "implicit"])
def test_the_split_layout_trains_over_a_mesh(implicit, shards):
    """Bitwise the single device's split training, with blocks of 5
    virtual rows: real rows straddle the single device's blocks, and
    positions (whole blocks each) begin inside real rows that an
    earlier position solves, whose sums it hands back."""
    r = skewed_ratings()
    p = pals.ALSParams(**SPLIT, implicit_prefs=implicit)
    with pytest.warns(UserWarning, match="split"):
        U1, V1 = pals.train_als(r, p, device="cpu")
    mesh = mesh_of(shards)
    with pytest.warns(UserWarning, match="split"):
        packed = pals.pack_ratings(r, p, mesh=mesh)
    carried = 0
    for side, h in (("user", packed.user_h), ("item", packed.item_h)):
        owners = h.row_ids.numpy()
        n_live = int(np.searchsorted(owners, h.n_rows))
        edges = range(5, n_live, 5)
        assert any(owners[e - 1] == owners[e] for e in edges), side
        ms = packed.mesh_side(side, p)
        assert ms.kind == "split" and len(ms.pieces) == shards
        # every piece is one of the single device's blocks, in order
        assert [int(pc.indices.shape[0]) for pcs in ms.pieces
                for pc in pcs] == [min(5, n_live - s)
                                   for s in range(0, n_live, 5)]
        assert ms.solves == sum(int(c.shape[0]) > 0
                                for c in ms.real_counts)
        carried += sum(pc.owners[0] < ms.row_cuts[k]
                       for k, pcs in enumerate(ms.pieces) for pc in pcs)
    assert carried
    U, V = pals.train_als(r, p, mesh=mesh, packed=packed)
    np.testing.assert_array_equal(whole(U, r.n_users),
                                  U1[:r.n_users].numpy())
    np.testing.assert_array_equal(whole(V, r.n_items),
                                  V1[:r.n_items].numpy())


@pytest.mark.parametrize("implicit", [False, True],
                         ids=["explicit", "implicit"])
def test_a_real_row_across_split_positions_trains_bitwise(implicit):
    """One user's 15 virtual rows run over blocks of 2 that six of 8
    positions hold: four positions solve no row and hand all their sums
    to the first, in block order; still the single device's factors bit
    for bit."""
    rng = np.random.default_rng(9)
    users = np.r_[np.zeros(60, np.int32), np.repeat(np.arange(1, 10), 2)]
    items = np.r_[np.arange(60), rng.integers(0, 60, 18)].astype(np.int32)
    users, items = pals.dedupe_pairs(users, items,
                                     np.ones(len(users), np.float32))[:2]
    vals = (rng.random(len(users)) * 4 + 1).astype(np.float32)
    r = pals.RatingsCOO(users, items, vals, 10, 60)
    p = pals.ALSParams(rank=4, num_iterations=2, seed=3, alpha=2.0,
                       history_mode="split", max_history=4, block_rows=2,
                       implicit_prefs=implicit)
    with pytest.warns(UserWarning, match="split"):
        U1, V1 = pals.train_als(r, p, device="cpu")
        packed = pals.pack_ratings(r, p, mesh=mesh_of(8))
    ms = packed.mesh_side("user", p)
    assert ms.row_cuts[:6] == (0, 1, 1, 1, 1, 1)
    assert ms.pieces[5][0].owners[0] == 0
    U, V = pals.train_als(r, p, mesh=mesh_of(8), packed=packed)
    np.testing.assert_array_equal(whole(U, r.n_users),
                                  U1[:r.n_users].numpy())
    np.testing.assert_array_equal(whole(V, r.n_items),
                                  V1[:r.n_items].numpy())


@pytest.mark.parametrize("implicit", [False, True],
                         ids=["explicit", "implicit"])
def test_the_split_layout_over_a_mesh_matches_the_jax_mesh8(mesh8,
                                                             implicit):
    """``tests/test_als.py::test_split_sharded_matches_single_device``'s
    limits (rtol 2e-3, atol 2e-4) against the JAX package's split
    training over ``mesh8``, from its draw."""
    r = skewed_ratings(seed=6)
    jr = jals.RatingsCOO(r.users, r.items, r.ratings, r.n_users, r.n_items)
    kw = dict(SPLIT, implicit_prefs=implicit, block_rows=None)
    with pytest.warns(UserWarning, match="split"):
        Uj, Vj = jals.train_als(jr, jals.ALSParams(**kw), mesh=mesh8)
    with pytest.warns(UserWarning, match="split"):
        U, V = pals.train_als(r, pals.ALSParams(**kw), mesh=mesh_of(4, 2),
                              init=jax_draw(3, r.n_users, r.n_items, 6))
    np.testing.assert_allclose(whole(U, r.n_users),
                               np.asarray(Uj)[:r.n_users], rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(whole(V, r.n_items),
                               np.asarray(Vj)[:r.n_items], rtol=2e-3,
                               atol=2e-4)


def test_a_process_mesh_packs_the_split_layout_as_buckets():
    """As the JAX package does (``pack_ratings_multihost``): the split
    layout has no layout over processes."""
    r = skewed_ratings()
    p = pals.ALSParams(**SPLIT)
    packed = pals.pack_ratings_multihost(r, p, mesh_of(4), force=True)
    assert {packed.user_h.kind, packed.item_h.kind} == {"bucket"}


def test_packed_for_another_mesh_is_refused():
    r = port_ratings(_ratings(seed=4))
    p = pals.ALSParams(rank=4, num_iterations=1)
    packed = pals.pack_ratings(r, p, mesh=mesh_of(4))
    with pytest.raises(ValueError, match="packed for another mesh"):
        pals.train_als(r, p, mesh=mesh_of(8), packed=packed)
    with pytest.raises(ValueError, match="packed for another mesh"):
        pals.train_als(r, p, mesh=mesh_of(4),
                       packed=pals.pack_ratings(r, p, "cpu"))


def test_the_engine_trains_over_the_contexts_mesh():
    from predictionio_tpu_torch.controller.base import DataSource
    from predictionio_tpu_torch.templates.recommendation import (
        TrainingData,
        recommendation_engine,
    )

    r = port_ratings(_ratings(seed=5))

    class DS(DataSource):
        def read_training(self, ctx):
            return TrainingData(
                r, BiMap({f"u{n}": n for n in range(r.n_users)}),
                BiMap({f"i{n}": n for n in range(r.n_items)}))

    engine = recommendation_engine(datasource_classes=DS)
    ep = engine.params_from_variant({"algorithms": [{"name": "als",
                                                     "params": {"rank": 4}}]})
    (one,) = engine.train(Context(device="cpu"), ep).models
    (meshed,) = engine.train(Context(device="cpu", mesh=mesh_of(8)),
                             ep).models
    # the mesh's tables come back whole (what a model blob stores)
    assert isinstance(meshed.user_factors, torch.Tensor)
    np.testing.assert_array_equal(meshed.user_factors[:r.n_users].numpy(),
                                  one.user_factors.numpy())
    np.testing.assert_array_equal(meshed.item_factors[:r.n_items].numpy(),
                                  one.item_factors.numpy())


def test_multi_process_packing_picks_the_one_process_layout():
    # one heavy user among many light ones: the padded matrix would fit
    # the cap but hold ~400x the entries, so one process packs the
    # bucketed layout (the JAX package's single-process rule); the
    # multi-process packing picks the same (the JAX package's own would
    # pad) and trains to the same factors
    rng = np.random.default_rng(6)
    n_users, n_items = 2000, 1600
    users = np.r_[np.zeros(1500, np.int32),
                  np.arange(1, n_users, dtype=np.int32)]
    items = np.r_[np.arange(1500, dtype=np.int32),
                  rng.integers(0, n_items, n_users - 1).astype(np.int32)]
    stars = rng.integers(1, 6, len(users)).astype(np.float32)
    jr = jals.RatingsCOO(users, items, stars, n_users, n_items)
    r = port_ratings(jr)
    p = pals.ALSParams(rank=4, num_iterations=2)
    assert type(jals.pack_ratings(jr, jals.ALSParams(rank=4)).user_h
                ).__name__ == "BucketedHistories"
    assert isinstance(pals.pack_ratings(r, p, "cpu").user_h,
                      pals.BucketedHistories)
    mesh = mesh_of(4)
    multi = pals.pack_ratings_multihost(r, p, mesh, force=True)
    assert multi.user_h.kind == "bucket"
    U1, V1 = pals.train_als(r, p, device="cpu")
    U, V = pals.train_als(r, p, mesh=mesh, packed=multi)
    np.testing.assert_array_equal(whole(U, n_users), U1[:n_users].numpy())
    np.testing.assert_array_equal(whole(V, n_items), V1[:n_items].numpy())


# -- the e-commerce and similar-product templates over the context's mesh ------


def template_training(template, explicit=False):
    """(port module, JAX module, app, events, port params, JAX params) of
    a template: e-commerce's implicit ALS, or similar-product's (implicit,
    or explicit for the bitwise variant)."""
    from test_templates import ecommerce_events, similarproduct_events

    import predictionio_tpu.templates.ecommerce as jec
    import predictionio_tpu.templates.similarproduct as jsp
    from predictionio_tpu.controller.params import EngineParams as JEP
    from predictionio_tpu_torch.controller.params import EngineParams
    from predictionio_tpu_torch.templates import ecommerce as pec
    from predictionio_tpu_torch.templates import similarproduct as psp

    if template == "ecommerce":
        def ep(pkg):
            return pkg.default_engine_params("ecapp", rank=8,
                                             num_iterations=5, seed=9)
        return pec, jec, "ecapp", ecommerce_events(), ep(pec), ep(jec)
    als = dict(rank=8, num_iterations=5, implicit_prefs=not explicit,
               alpha=1.0, seed=5)

    def ep(pkg, ep_cls, params_cls):
        return ep_cls(datasource=("", pkg.DataSourceParams(app_name="spapp")),
                      algorithms=[("als", params_cls(**als))])
    return (psp, jsp, "spapp", similarproduct_events(),
            ep(psp, EngineParams, pals.ALSParams),
            ep(jsp, JEP, jals.ALSParams))


def engine_of(pkg):
    return (pkg.ecommerce_engine() if hasattr(pkg, "ecommerce_engine")
            else pkg.similarproduct_engine())


def template_factors(model):
    """Each factor table a template's model keeps, trimmed to its rows."""
    tables = [model.item_factors]
    if hasattr(model, "user_factors"):
        tables.append(model.user_factors)
    return [np.asarray(t) for t in tables]


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("template,explicit",
                         [("ecommerce", False), ("similarproduct", False),
                          ("similarproduct", True)],
                         ids=["ecommerce", "similarproduct",
                              "similarproduct-explicit"])
def test_a_template_trains_over_the_contexts_mesh(template, explicit, shards,
                                                  monkeypatch):
    from test_torch_templates import Pair, _jax_draw

    from predictionio_tpu_torch.templates import _common

    monkeypatch.setattr(pals, "draw_initial_factors", _jax_draw)
    meshes = []

    def spy(*args, **kw):
        meshes.append(kw.get("mesh"))
        return pals.train_als(*args, **kw)

    monkeypatch.setattr(_common, "train_als", spy)
    pkg, _, app, events, ep, _ = template_training(template, explicit)
    pair = Pair(app, events)
    (one,) = engine_of(pkg).train(pair.ctx, ep).models
    meshed_ctx = Context(device="cpu", app_name=app, _storage=pair.store,
                         mesh=mesh_of(shards))
    (meshed,) = engine_of(pkg).train(meshed_ctx, ep).models
    assert meshes == [None, meshed_ctx.mesh]
    for g, w in zip(template_factors(meshed), template_factors(one)):
        assert g.shape == w.shape
        # within 1e-5 (1 + |x|) is the bound; every device takes the
        # implicit Gramian as the single device does, so it is exact
        assert np.all(np.abs(g - w) <= 1e-5 * (1 + np.abs(w)))
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("template", ["ecommerce", "similarproduct"])
def test_a_template_over_a_mesh_matches_the_jax_mesh_training(mesh8,
                                                              template,
                                                              monkeypatch):
    from predictionio_tpu.controller.context import Context as JContext
    from test_torch_templates import Pair, _jax_draw

    monkeypatch.setattr(pals, "draw_initial_factors", _jax_draw)
    pkg, jpkg, app, events, ep, jep = template_training(template)
    pair = Pair(app, events)
    (mine,) = engine_of(pkg).train(
        Context(device="cpu", app_name=app, _storage=pair.store,
                mesh=mesh_of(4)), ep).models
    (theirs,) = engine_of(jpkg).train(
        JContext(app_name=app, _storage=pair.jstore, mesh=mesh8), jep).models
    for g, w in zip(template_factors(mine), template_factors(theirs)):
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-4)
