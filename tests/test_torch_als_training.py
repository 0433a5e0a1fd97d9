"""The port's ALS training against the JAX package's ``train_als``.

Both start from the same initial factors: the JAX package's own draw,
reproduced as its ``train_als`` makes it (``jax.random.split`` of the
seed's key, then ``_init_factors`` per side) and handed to the port's
``train_als(init=...)``. The port trains on the CPU (every kernel's plain
version); the JAX side runs under ``JAX_PLATFORMS=cpu``, its fused
Gramian in interpret mode. Tolerance: the factors agree within rtol
2e-3, atol 2e-4 after 1 and 3 iterations (the tolerance
``tests/test_als.py`` holds the JAX package to against float64 numpy).
Then a model trained by the port's ``Engine.train`` goes through the
model file and ``deploy_models(device="cpu")``, and its ``/queries.json``
answers are held against the JAX package's for the JAX-trained model.
"""

import dataclasses
import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

import predictionio_tpu.models.als as jals
from predictionio_tpu_torch.controller.base import DataSource
from predictionio_tpu_torch.controller.context import Context
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.models.convert import factors_to_numpy
from predictionio_tpu_torch.ops import ragged
from predictionio_tpu_torch.server.engineserver import ServerConfig, deploy_models
from predictionio_tpu_torch.templates.recommendation import (
    TrainingData,
    recommendation_engine,
)
from predictionio_tpu_torch.workflow.persistence import (
    dumps_models,
    loads_models,
)

N_USERS, N_ITEMS = 36, 28


def make_ratings(seed=0):
    """Skewed explicit ratings: a dense head user and item, empty rows on
    both sides, so the bucket layout has several length classes."""
    rng = np.random.default_rng(seed)
    mask = rng.random((N_USERS, N_ITEMS)) < 0.25
    mask[0, :] = True        # a long user history
    mask[:, 1] = True        # a long item history
    mask[5, :] = False       # a user with none
    mask[:, 9] = False       # an item with none
    u, i = np.nonzero(mask)
    order = rng.permutation(len(u))
    vals = rng.integers(1, 11, len(u)).astype(np.float32) / 2.0
    return (u[order].astype(np.int32), i[order].astype(np.int32),
            vals[order])


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


def both(seed=0):
    u, i, v = make_ratings(seed)
    return (jals.RatingsCOO(u, i, v, N_USERS, N_ITEMS),
            als.RatingsCOO(u, i, v, N_USERS, N_ITEMS))


VARIANTS = {
    "explicit_pad_fused": dict(history_mode="pad", gram_mode="fused"),
    "explicit_pad_einsum": dict(history_mode="pad", gram_mode="einsum"),
    "explicit_bucket_fused": dict(history_mode="bucket", gram_mode="fused"),
    "explicit_bucket_einsum": dict(history_mode="bucket",
                                   gram_mode="einsum"),
    "implicit_pad_fused": dict(history_mode="pad", gram_mode="fused",
                               implicit_prefs=True, alpha=2.0),
    "implicit_bucket_einsum": dict(history_mode="bucket",
                                   gram_mode="einsum", implicit_prefs=True),
    "bf16_gather_bucket_fused": dict(history_mode="bucket",
                                     gram_mode="fused",
                                     gather_dtype="bfloat16"),
    "bf16_gather_pad_einsum_implicit": dict(
        history_mode="pad", gram_mode="einsum", gather_dtype="bfloat16",
        implicit_prefs=True),
    # one iteration only: bf16 rounds the Gramian's operands, so factors
    # that differ in their last f32 bits after one iteration can round
    # to neighbouring bf16 values in the next (~4e-3 relative), which is
    # bf16 noise and not a difference of the algorithm
    "bf16_matmul_einsum": dict(history_mode="pad", gram_mode="einsum",
                               matmul_dtype="bfloat16", iterations=(1,)),
    "no_reg_scaling_auto": dict(scale_reg_by_count=False),
    "max_history_cap_blocks": dict(max_history=6, block_rows=5),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_factors_match_jax(name):
    jr, pr = both()
    kw = dict(rank=6, reg=0.05, seed=11, **VARIANTS[name])
    for iters in kw.pop("iterations", (1, 3)):
        jp = jals.ALSParams(num_iterations=iters, **kw)
        U0, V0 = jax_init(jp, jr)
        Uj, Vj = jals.train_als(jr, jp)
        Up, Vp = als.train_als(pr, als.ALSParams(num_iterations=iters, **kw),
                               device="cpu", init=(U0, V0))
        assert Up.shape == tuple(Uj.shape) and Vp.shape == tuple(Vj.shape)
        np.testing.assert_allclose(Up.numpy(), np.asarray(Uj), rtol=2e-3,
                                   atol=2e-4, err_msg=f"U after {iters}")
        np.testing.assert_allclose(Vp.numpy(), np.asarray(Vj), rtol=2e-3,
                                   atol=2e-4, err_msg=f"V after {iters}")
        # rows with no history keep factor 0
        assert not Up[5].any() and not Vp[9].any()


def test_layouts_and_flops_match_jax():
    jr, pr = both()
    for mode in ("pad", "bucket", "auto"):
        jp = jals.ALSParams(rank=6, history_mode=mode)
        pp = als.ALSParams(rank=6, history_mode=mode)
        jpk = jals.pack_ratings(jr, jp)
        ppk = als.pack_ratings(pr, pp, device="cpu")
        for jh, ph in zip(jpk, ppk):
            assert type(ph).__name__ == type(jh).__name__
        assert als.als_flops_per_iter(*ppk, pp) == \
            jals.als_flops_per_iter(*jpk, jp)


def test_default_init_is_seeded_and_pads_with_zeros():
    _, pr = both()
    p = als.ALSParams(rank=4, num_iterations=0, seed=3)
    U1, V1 = als.train_als(pr, p, device="cpu")
    U2, V2 = als.train_als(pr, p, device="cpu")
    assert torch.equal(U1, U2) and torch.equal(V1, V2)
    assert 0.1 < U1.std().item() < 1.0
    Ua, _ = als.draw_initial_factors(3, 4, 6, 2, 2, 4)
    assert not Ua[4:].any() and Ua[:4].all()
    with pytest.raises(ValueError, match="init user factors"):
        als.train_als(pr, p, device="cpu",
                      init=(np.zeros((N_USERS, 5)), np.zeros((N_ITEMS, 4))))


def test_split_layout_is_not_ported_and_empty_ratings_refused():
    # the split layout is ported now: it trains, with the JAX package's
    # warning that "bucket" is the drop-free layout of choice
    _, pr = both()
    with pytest.warns(UserWarning, match="'bucket' is the drop-free"):
        U, V = als.train_als(pr, als.ALSParams(history_mode="split",
                                               num_iterations=1),
                             device="cpu")
    assert bool(torch.isfinite(U).all()) and bool(torch.isfinite(V).all())
    empty = als.RatingsCOO(np.zeros(0, np.int32), np.zeros(0, np.int32),
                           np.zeros(0, np.float32), 3, 3)
    with pytest.raises(ValueError, match="non-empty"):
        als.train_als(empty, als.ALSParams(), device="cpu")


def test_pack_ratings_cached_memoizes_per_layout():
    _, pr = both()
    p = als.ALSParams(rank=4)
    a = als.pack_ratings_cached(pr, p, device="cpu")
    assert als.pack_ratings_cached(pr, dataclasses.replace(p, rank=8),
                                   device="cpu") is a
    b = als.pack_ratings_cached(
        pr, dataclasses.replace(p, history_mode="pad"), device="cpu")
    assert b is not a and isinstance(b.user_h, ragged.PaddedHistories)


# -- Engine.train, the model file, deploy and /queries.json -----------------

RANK, SEED = 6, 4


class ListDataSource(DataSource):
    """The caller's own data source: rating triples with string ids."""

    def __init__(self, params=None):
        pass

    def read_training(self, ctx):
        u, i, v = make_ratings(1)
        return TrainingData(
            als.RatingsCOO(u, i, v, N_USERS, N_ITEMS),
            BiMap({f"u{n}": n for n in range(N_USERS)}),
            BiMap({f"i{n}": n for n in range(N_ITEMS)}))


VARIANT = {"datasource": {"params": {}},
           "algorithms": [{"name": "als", "params": {
               "rank": RANK, "numIterations": 3, "lambda": 0.05,
               "seed": SEED}}]}


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(req, timeout=30) as resp:
        return json.loads(resp.read())


def test_engine_train_persist_deploy_matches_jax(monkeypatch):
    u, i, v = make_ratings(1)
    jr = jals.RatingsCOO(u, i, v, N_USERS, N_ITEMS)
    jp = jals.ALSParams(rank=RANK, num_iterations=3, reg=0.05, seed=SEED)
    U0, V0 = jax_init(jp, jr)
    Uj, Vj = (np.asarray(t) for t in jals.train_als(jr, jp))

    # the port's Engine.train starts from the JAX package's draw
    monkeypatch.setattr(
        als, "draw_initial_factors",
        lambda *a, **k: (torch.from_numpy(U0), torch.from_numpy(V0)))
    engine = recommendation_engine(datasource_classes=ListDataSource)
    ep = engine.params_from_variant(VARIANT)
    assert ep.preparator == ("", None) and ep.datasource[0] == ""
    ctx = Context(device="cpu")
    result = engine.train(ctx, ep)
    assert set(ctx.stage_timings) == {"read_s", "prepare_s", "algo_train_s"}
    (model,) = result.models
    np.testing.assert_allclose(model.user_factors.numpy(), Uj, rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(model.item_factors.numpy(), Vj, rtol=2e-3,
                               atol=2e-4)

    (loaded,) = loads_models(dumps_models(result.models))
    assert torch.equal(loaded.user_factors, model.user_factors)
    srv = deploy_models(engine, ep, [loaded], ServerConfig(device="cpu"),
                 host="127.0.0.1", port=0)
    srv.start_background()
    try:
        for user, num in (("u0", 5), ("u3", 10), ("u17", 28), ("u5", 4)):
            got = _post(srv.port, {"user": user, "num": num})["itemScores"]
            uidx = int(user[1:])
            want = np.sort(Vj[:N_ITEMS] @ Uj[uidx])[::-1][:num]
            assert len(got) == num
            scores = np.array([g["score"] for g in got])
            # rank by rank, the port's scores are the JAX model's
            np.testing.assert_allclose(scores, want, rtol=2e-3, atol=2e-3)
            # and each returned item scores that under the JAX factors
            own = np.array([Vj[int(g["item"][1:])] @ Uj[uidx] for g in got])
            np.testing.assert_allclose(own, scores, rtol=2e-3, atol=2e-3)
        assert _post(srv.port, {"user": "nobody", "num": 3}) == \
            {"itemScores": []}
    finally:
        srv.close()


def test_engine_train_defaults_to_the_card(monkeypatch):
    """A Context with no device trains on the card, and raises where
    there is none: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    engine = recommendation_engine(datasource_classes=ListDataSource)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.train(Context(), engine.params_from_variant(VARIANT))


def test_engine_train_stops_early_and_checks_sanity():
    engine = recommendation_engine(datasource_classes=ListDataSource)
    ep = engine.params_from_variant(VARIANT)
    assert engine.train(Context(device="cpu", stop_after_read=True),
                        ep).models == []
    assert engine.train(Context(device="cpu", stop_after_prepare=True),
                        ep).models == []

    class Empty(ListDataSource):
        def read_training(self, ctx):
            z = np.zeros(0, np.int32)
            return TrainingData(als.RatingsCOO(z, z, z.astype(np.float32),
                                               1, 1), BiMap({}), BiMap({}))

    engine = recommendation_engine(datasource_classes=Empty)
    with pytest.raises(ValueError, match="no ratings"):
        engine.train(Context(device="cpu"), ep)
    with pytest.raises(KeyError, match="datasource"):
        recommendation_engine(datasource_classes={"other": Empty}).train(
            Context(device="cpu"), ep)
    # the default data source reads the event store: an app must exist
    from predictionio_tpu_torch.data.storage.base import StorageError
    from predictionio_tpu_torch.data.storage.registry import Storage

    memory = Storage(env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
    with pytest.raises(StorageError, match="does not exist"):
        recommendation_engine().train(
            Context(device="cpu", _storage=memory), ep)
