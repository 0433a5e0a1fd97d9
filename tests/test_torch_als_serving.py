"""The port's ALS serving against the JAX package's, on the same numbers.

A JAX-package ``ALSModel`` built from numpy factors is carried across
with ``als_model_from_numpy``; the port runs on the CPU (its plain
versions). The JAX side is forced onto its device path
(``HOST_SERVE_WORK = 0``, test-side only). Tolerances: f32 ids exact and
scores rtol 1e-5 (summation order differs); bf16 and int8 scores rtol
1e-4 and ids exact where neighbouring scores are more than 1e-4 apart.
Quantized tables are compared bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import predictionio_tpu.models.als as jals
from predictionio_tpu.controller.params import params_from_json as jax_params
from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu_torch.controller.params import params_from_json
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.models.convert import als_model_from_numpy
from predictionio_tpu_torch.workflow.persistence import (
    dumps_models,
    loads_models,
)


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setattr(jals, "HOST_SERVE_WORK", 0)


def jax_model(m=48, I=160, r=16, seed=0, U=None, V=None):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(m, r)).astype(np.float32) if U is None else U
    V = rng.normal(size=(I, r)).astype(np.float32) if V is None else V
    return jals.ALSModel(
        user_factors=U, item_factors=V, n_users=U.shape[0],
        n_items=V.shape[0],
        user_ids=JaxBiMap.string_int(f"u{i}" for i in range(U.shape[0])),
        item_ids=JaxBiMap.string_int(f"i{i}" for i in range(V.shape[0])),
        params=jals.ALSParams(rank=U.shape[1]))


def carry(jm, device="cpu"):
    """The port's model from what the JAX model holds."""
    def leaves(t):
        if isinstance(t, jals.QuantizedFactors):
            return (np.asarray(t.data),
                    None if t.scale is None else np.asarray(t.scale))
        return np.asarray(t), None

    (u, us), (v, vs) = leaves(jm.user_factors), leaves(jm.item_factors)
    return als_model_from_numpy(
        u, v, jm.n_users, jm.n_items, dict(jm.user_ids.items()),
        dict(jm.item_ids.items()), dataclasses.asdict(jm.params),
        user_scale=us, item_scale=vs, quant=jals.table_quant(jm.item_factors),
        device=device)


def tie_free_rows(U64, V64, users, k, gap):
    s = U64[users] @ V64.T
    top = -np.sort(-s, axis=1)[:, :k + 1]
    return np.all(np.abs(np.diff(top, axis=1)) > gap, axis=1)


class TestRecommend:
    @pytest.mark.parametrize("k", [10, 7, 160])
    def test_recommend_products_f32(self, k):
        jm = jax_model()
        pm = carry(jm)
        for u in (0, 5, 47):
            ji, js = jals.recommend_products(jm, u, k)
            pi, ps = als.recommend_products(pm, u, k)
            np.testing.assert_array_equal(pi, np.asarray(ji))
            np.testing.assert_allclose(ps, np.asarray(js), rtol=1e-5,
                                       atol=1e-6)

    @pytest.mark.parametrize("k", [10, 150])  # 150 > TOPK_MAX_K: _serve_topk
    def test_recommend_batch_f32(self, k):
        jm = jax_model(seed=2)
        pm = carry(jm)
        users = np.random.default_rng(2).integers(0, 48, 13)
        ji, js = jals.recommend_batch(jm, users, k)
        pi, ps = als.recommend_batch(pm, users, k)
        assert pi.shape == (13, k) and ps.shape == (13, k)
        np.testing.assert_array_equal(pi, np.asarray(ji))
        np.testing.assert_allclose(ps, np.asarray(js), rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("quant", ["bf16", "int8"])
    def test_recommend_batch_quantized(self, quant):
        jq = jals.quantize_serving_model(jax_model(seed=4), quant)
        assert jals.table_quant(jq.item_factors) == quant
        pm = carry(jq)
        assert als.table_quant(pm.item_factors) == quant
        users = np.random.default_rng(4).integers(0, 48, 16)
        ji, js = jals.recommend_batch(jq, users, 10)
        pi, ps = als.recommend_batch(pm, users, 10)
        np.testing.assert_allclose(ps, np.asarray(js), rtol=1e-4, atol=1e-4)
        U64 = als.table_host_f32(pm.user_factors).astype(np.float64)
        V64 = als.table_host_f32(pm.item_factors).astype(np.float64)
        rows = tie_free_rows(U64, V64, users, 10, 1e-4)
        assert rows.sum() >= 12
        np.testing.assert_array_equal(pi[rows], np.asarray(ji)[rows])

    def test_empty_batch_and_predict_rating(self):
        jm = jax_model()
        pm = carry(jm)
        ids, scores = als.recommend_batch(pm, np.empty(0, np.int64), 10)
        assert ids.shape == (0, 10) and scores.shape == (0, 10)
        assert als.predict_rating(pm, 3, 7) == pytest.approx(
            jals.predict_rating(jm, 3, 7), rel=1e-6)

    def test_async_resolver_matches_sync(self):
        pm = carry(jax_model())
        users = np.arange(9)
        resolve = als.recommend_batch_async(pm, users, 10)
        a = resolve()
        b = als.recommend_batch(pm, users, 10)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


class TestQuantization:
    def test_int8_rows_bitwise(self):
        rows = np.random.default_rng(9).normal(size=(64, 24)).astype(
            np.float32) * 3
        rows[5] = 0.0  # an all-zero row takes the 1e-12 floor
        jd, jsc = jals._quantize_rows(rows, "int8")
        pd, psc = als._quantize_rows(rows, "int8")
        assert pd.dtype == torch.int8 and psc.dtype == torch.float32
        np.testing.assert_array_equal(pd.numpy(), jd)
        np.testing.assert_array_equal(psc.numpy().view(np.uint32),
                                      jsc.view(np.uint32))

    def test_bf16_rows_bitwise(self):
        rows = np.random.default_rng(10).normal(size=(64, 24)).astype(
            np.float32) * 1e3
        jd, _ = jals._quantize_rows(rows, "bf16")
        pd, ps = als._quantize_rows(rows, "bf16")
        assert ps is None and pd.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            pd.view(torch.int16).numpy().view(np.uint16),
            np.asarray(jd).view(np.uint16))

    def test_carried_tables_are_bitwise(self):
        for quant in ("bf16", "int8"):
            jq = jals.quantize_serving_model(jax_model(), quant)
            pm = carry(jq)
            pq = als.quantize_serving_model(carry(jax_model()), quant)
            for side in ("user_factors", "item_factors"):
                a, b = getattr(pm, side), getattr(pq, side)
                assert torch.equal(a.data.view(torch.uint8),
                                   b.data.view(torch.uint8))
                if quant == "int8":
                    assert torch.equal(a.scale, b.scale)

    @staticmethod
    def adversarial_model():
        """One huge shared dimension sets every row's absmax; the ranking
        lives in dimensions int8 rounds to zero (bf16 keeps them)."""
        rng = np.random.default_rng(12)
        U = rng.normal(size=(64, 8)).astype(np.float32) * 1e-3
        V = rng.normal(size=(200, 8)).astype(np.float32) * 1e-3
        U[:, 0] = 1.0
        V[:, 0] = 1000.0
        U[:, 1] = 100.0
        return jax_model(U=U, V=V)

    @pytest.mark.parametrize("which", ["normal", "adversarial"])
    @pytest.mark.parametrize("quant", ["bf16", "int8"])
    def test_same_auto_off_decision(self, which, quant):
        jm = jax_model() if which == "normal" else self.adversarial_model()
        jq = jals.quantize_serving_model(jm, quant)
        pq = als.quantize_serving_model(carry(jm), quant)
        assert als.table_quant(pq.item_factors) \
            == jals.table_quant(jq.item_factors)
        U = np.asarray(jm.user_factors)
        V = np.asarray(jm.item_factors)
        jn = jals.serving_quant_ndcg(
            U, V, jals.QuantizedFactors(*jals._quantize_rows(U, quant),
                                        quant=quant),
            jals.QuantizedFactors(*jals._quantize_rows(V, quant),
                                  quant=quant), jm.n_items)
        pn = als.serving_quant_ndcg(
            U, V, als.QuantizedFactors(*als._quantize_rows(U, quant),
                                       quant=quant),
            als.QuantizedFactors(*als._quantize_rows(V, quant),
                                 quant=quant), jm.n_items)
        assert pn == pytest.approx(jn, abs=1e-12)

    def test_adversarial_model_really_switches_int8_off(self):
        pq = als.quantize_serving_model(carry(self.adversarial_model()),
                                        "int8")
        assert als.table_quant(pq.item_factors) == "off"

    def test_bad_quant_raises(self):
        with pytest.raises(ValueError, match="serving quant"):
            als.quantize_serving_model(carry(jax_model()), "fp8")


class TestParamsAndPersistence:
    def test_params_alias_and_validation_match(self):
        wire = {"rank": 12, "numIterations": 5, "lambda": 0.25, "seed": 7}
        p = params_from_json(als.ALSParams, wire)
        j = jax_params(jals.ALSParams, wire)
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
        assert p.reg == 0.25
        with pytest.raises(ValueError):
            params_from_json(als.ALSParams, {"rnk": 3})
        with pytest.raises(ValueError):
            als.ALSParams(gram_mode="nope")

    @pytest.mark.parametrize("quant", ["off", "bf16", "int8"])
    def test_model_file_round_trip(self, quant):
        pm = carry(jax_model())
        pm = als.quantize_serving_model(pm, quant)
        back, = loads_models(dumps_models([pm]))
        assert back.n_users == pm.n_users and back.n_items == pm.n_items
        assert back.params == pm.params
        assert dict(back.item_ids.items()) == dict(pm.item_ids.items())
        for side in ("user_factors", "item_factors"):
            a, b = getattr(pm, side), getattr(back, side)
            assert als.table_quant(a) == als.table_quant(b) == quant
            ad, asc = als._table_leaves(a)
            bd, bsc = als._table_leaves(b)
            assert ad.dtype == bd.dtype
            assert torch.equal(ad.view(torch.uint8), bd.view(torch.uint8))
            assert (asc is None) == (bsc is None)
            if asc is not None:
                assert torch.equal(asc, bsc)

    def test_model_file_holds_no_pickle(self):
        blob = dumps_models([carry(jax_model())])
        import io
        import zipfile
        names = zipfile.ZipFile(io.BytesIO(blob)).namelist()
        assert "meta.npy" in names
        with np.load(io.BytesIO(blob), allow_pickle=False) as z:
            assert all(z[n].dtype != object for n in z.files)


class TestRouting:
    @pytest.mark.parametrize("k,kernel", [(10, True), (128, True),
                                          (129, False), (160, False)])
    def test_kernel_up_to_its_limit_plain_past_it(self, monkeypatch, k,
                                                   kernel):
        """k_dev <= TOPK_MAX_K goes to fused_topk (the kernel on the
        card), larger k to _serve_topk — as the JAX package routes it."""
        calls = []
        real = als.fused_topk

        def spy(*args, **kw):
            calls.append(kw["k"])
            return real(*args, **kw)

        monkeypatch.setattr(als, "fused_topk", spy)
        pm = carry(jax_model(I=200))
        ids, scores = als.recommend_batch(pm, np.arange(4), k)
        assert ids.shape == (4, k)
        assert bool(calls) == kernel
        if kernel:
            assert calls == [als._compiled_k(k, 200)]
