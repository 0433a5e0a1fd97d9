"""The port's fused gather -> score -> top-k against the JAX package's.

The JAX kernel runs in Pallas interpret mode (as tests/test_fused_topk.py
runs it); the port's ``fused_topk`` gets the same numpy inputs as CPU
tensors, so it runs its plain version. Tolerances: f32 sums in another
order in the two packages, so scores agree to rtol 1e-5 and ids exactly
(the seeds leave no two scores within 1e-5 at the k boundary); on the
bf16 and int8 wires scores agree to rtol 1e-4 and ids exactly wherever
neighbouring scores are more than 1e-4 apart.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.models.als import _quantize_rows as jax_quantize_rows
from predictionio_tpu.ops.fused_topk import fused_topk as jax_fused_topk
from predictionio_tpu.ops.fused_topk import (
    fused_topk_reference as jax_fused_topk_reference,
)
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops import fused_topk as ft


def make_tables(m=120, I=200, r=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, r)).astype(np.float32),
            rng.normal(size=(I, r)).astype(np.float32))


def wire_inputs(U, V, wire):
    """(jax args, torch args) for one wire: tables and scales."""
    if wire == "f32":
        return ((jnp.asarray(U), jnp.asarray(V), None, None),
                (torch.from_numpy(U), torch.from_numpy(V), None, None))
    if wire == "bf16":
        return ((jnp.asarray(U).astype(jnp.bfloat16),
                 jnp.asarray(V).astype(jnp.bfloat16), None, None),
                (torch.from_numpy(U).bfloat16(),
                 torch.from_numpy(V).bfloat16(), None, None))
    Uq, us = jax_quantize_rows(U, "int8")
    Vq, vs = jax_quantize_rows(V, "int8")
    return ((jnp.asarray(Uq), jnp.asarray(Vq), jnp.asarray(us),
             jnp.asarray(vs)),
            (torch.from_numpy(Uq), torch.from_numpy(Vq),
             torch.from_numpy(us), torch.from_numpy(vs)))


def run_both(U, V, idx, wire="f32", *, k, n_items, base=None,
             jax_fn="kernel"):
    (ju, jv, jus, jvs), (tu, tv, tus, tvs) = wire_inputs(U, V, wire)
    jbase = None if base is None else jnp.asarray(base, jnp.int32)
    if jax_fn == "kernel":
        js, ji = jax_fused_topk(ju, jnp.asarray(idx.astype(np.int32)), jv,
                                jus, jvs, jbase, k=k, n_items=n_items,
                                chunk=64, interpret=True)
    else:
        js, ji = jax_fused_topk_reference(
            ju, jnp.asarray(idx.astype(np.int32)), jv, jus, jvs, jbase,
            k=k, n_items=n_items)
    ts, ti = ft.fused_topk(tu, torch.from_numpy(idx.astype(np.int32)), tv,
                           tus, tvs, base, k=k, n_items=n_items)
    return (np.asarray(js), np.asarray(ji)), (ts.numpy(), ti.numpy())


def dequantized(U, V, wire):
    _, (tu, tv, tus, tvs) = wire_inputs(U, V, wire)
    u, v = tu.double().numpy(), tv.double().numpy()
    if tus is not None:
        u, v = u * tus.double().numpy(), v * tvs.double().numpy()
    return u, v


def tie_free_rows(U, V, idx, k, n_items, gap, base=0):
    """Rows whose k+1 best scores (float64, masked like the kernel) are
    pairwise more than ``gap`` apart: there the order cannot depend on
    the summation order."""
    s = U[idx] @ V.T
    s[:, np.arange(V.shape[0]) + base >= n_items] = -np.inf
    top = -np.sort(-s, axis=1)[:, :k + 1]
    d = np.abs(np.diff(top, axis=1))
    return np.all((d > gap) | ~np.isfinite(d), axis=1)


class TestAgainstJaxKernel:
    def test_f32_ids_exact(self):
        U, V = make_tables()
        idx = np.random.default_rng(1).integers(0, U.shape[0], 24)
        u64, v64 = dequantized(U, V, "f32")
        assert tie_free_rows(u64, v64, idx, 10, V.shape[0], 1e-5).all()
        (js, ji), (ts, ti) = run_both(U, V, idx, k=10, n_items=V.shape[0])
        assert ts.shape == (24, 10) and ts.dtype == np.float32
        assert ti.dtype == np.int32
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("wire", ["bf16", "int8"])
    def test_quantized_wires(self, wire):
        U, V = make_tables(seed=3)
        idx = np.random.default_rng(3).integers(0, U.shape[0], 15)
        (js, ji), (ts, ti) = run_both(U, V, idx, wire, k=10,
                                      n_items=V.shape[0])
        np.testing.assert_allclose(ts, js, rtol=1e-4, atol=1e-4)
        u64, v64 = dequantized(U, V, wire)
        rows = tie_free_rows(u64, v64, idx, 10, V.shape[0], 1e-4)
        assert rows.sum() >= 10  # the check below has rows to bite on
        np.testing.assert_array_equal(ti[rows], ji[rows])

    @pytest.mark.parametrize("B,I,k,n_items,base", [
        (1, 33, 8, 33, None),      # one query, catalog below one chunk
        (13, 97, 1, 97, None),     # k=1, ragged B and catalog
        (19, 130, 128, 130, None),  # k at the kernel's limit
        (7, 140, 12, 100, None),   # padded items masked
        (9, 150, 8, 1100, 1000),   # ids offset by base; past n_items masked
    ])
    def test_ragged_base_and_mask(self, B, I, k, n_items, base):
        U, V = make_tables(I=I, seed=B * 31 + I)
        idx = np.random.default_rng(B).integers(0, U.shape[0], B)
        (js, ji), (ts, ti) = run_both(U, V, idx, k=k, n_items=n_items,
                                      base=base)
        u64, v64 = dequantized(U, V, "f32")
        rows = tie_free_rows(u64, v64, idx, k, n_items, 1e-5,
                             base=base or 0)
        assert rows.all()
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-6)
        assert ti.max() < n_items and ti.min() >= (base or 0)

    @pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
    @pytest.mark.parametrize("k", [1, 8, 128])
    def test_exact_ties_lower_id_first(self, wire, k):
        """Integer-valued factors make every product exact: scores tie
        exactly and the order is the id order alone."""
        rng = np.random.default_rng(5)
        U = rng.integers(-2, 3, (40, 8)).astype(np.float32)
        V = rng.integers(-2, 3, (200, 8)).astype(np.float32)
        idx = rng.integers(0, 40, 6)
        if wire == "int8":
            # unit scales keep the integer values exact on the int8 wire
            s, i = ft.fused_topk(
                torch.from_numpy(U.astype(np.int8)),
                torch.from_numpy(idx.astype(np.int32)),
                torch.from_numpy(V.astype(np.int8)),
                torch.ones(40, 1), torch.ones(200, 1), k=k, n_items=200)
            js, ji = jax_fused_topk(
                jnp.asarray(U.astype(np.int8)),
                jnp.asarray(idx.astype(np.int32)),
                jnp.asarray(V.astype(np.int8)), jnp.ones((40, 1)),
                jnp.ones((200, 1)), k=k, n_items=200, chunk=64,
                interpret=True)
            ts, ti = s.numpy(), i.numpy()
        else:
            (js, ji), (ts, ti) = run_both(U, V, idx, wire, k=k,
                                          n_items=200)
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_array_equal(ts, np.asarray(js))
        # within every run of equal scores the ids ascend
        same = ts[:, 1:] == ts[:, :-1]
        assert (ti[:, 1:] > ti[:, :-1])[same].all()
        if k > 1:
            assert same.any()  # the case really has ties


class TestAgainstJaxReference:
    @pytest.mark.parametrize("I,k,n_items", [(20, 32, 20), (20, 32, 15),
                                             (30, 16, 10)])
    def test_past_the_catalog(self, I, k, n_items):
        """k past the catalog pads (-inf, 0); masked items rank last in
        id order — the JAX reference's lax.top_k semantics."""
        U, V = make_tables(I=I, seed=11)
        idx = np.arange(5)
        (js, ji), (ts, ti) = run_both(U, V, idx, k=k, n_items=n_items,
                                      jax_fn="reference")
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-6)
        assert np.isneginf(ts[:, n_items:]).all()


class TestWrapperContract:
    def test_cpu_tensors_take_the_plain_version(self):
        U, V = make_tables()
        idx = torch.arange(8, dtype=torch.int32)
        before = ft.LAUNCHES
        s, i = ft.fused_topk(torch.from_numpy(U), idx, torch.from_numpy(V),
                             k=8, n_items=200)
        rs, ri = ft.fused_topk_reference(torch.from_numpy(U), idx,
                                         torch.from_numpy(V), k=8,
                                         n_items=200)
        assert ft.LAUNCHES == before
        assert torch.equal(s, rs) and torch.equal(i, ri)

    @pytest.mark.parametrize("k", [0, ft.TOPK_MAX_K + 1])
    def test_k_out_of_range_raises(self, k):
        U, V = make_tables()
        with pytest.raises(ValueError, match="k"):
            ft.fused_topk(torch.from_numpy(U), torch.arange(4),
                          torch.from_numpy(V), k=k, n_items=200)

    def test_unpaired_scale_raises(self):
        U, V = make_tables()
        with pytest.raises(ValueError, match="both"):
            ft.fused_topk(torch.from_numpy(U), torch.arange(4),
                          torch.from_numpy(V), torch.ones(120, 1), None,
                          k=4, n_items=200)

    def test_other_devices_raise(self):
        """No silent CPU path for tensors that live elsewhere."""
        u = torch.empty(10, 4, device="meta")
        v = torch.empty(20, 4, device="meta")
        with pytest.raises(ValueError, match="cuda or cpu"):
            ft.fused_topk(u, torch.empty(3, dtype=torch.int32,
                                         device="meta"), v, k=4,
                          n_items=20)

    def test_kernel_source_agrees_with_wrapper(self):
        """The .cu limits and C entry points are the ones the wrapper
        checks and binds."""
        src = (_build.CSRC / "fused_topk.cu").read_text()
        assert int(re.search(r"kMaxK = (\d+)", src).group(1)) \
            == ft.TOPK_MAX_K
        assert int(re.search(r"kMaxRank = (\d+)", src).group(1)) \
            == ft.TOPK_MAX_RANK
        for const, want in (("kMaxQB", ft.TOPK_MAX_QB),
                            ("kMaxChunk", ft.TOPK_MAX_CHUNK),
                            ("kMinChunk", ft.TOPK_MIN_CHUNK)):
            assert int(re.search(rf"{const} = (\d+)", src).group(1)) == want
        assert int(re.search(r"kEmptyId = (0x[0-9a-f]+)", src).group(1),
                   16) == ft.EMPTY_ID
        # tensor cores on the int8 and bf16 wires, asynchronous 16-byte
        # tile copies, and no library or device-memory atomic in the body
        assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in src
        assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
        assert "cp.async.cg.shared.global" in src
        assert "cublas" not in src.lower() and "cutlass" not in src.lower()
        for name in ft._ENTRY.values():
            assert f"FUSED_TOPK_ENTRY({name}," in src
        assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
        assert _build.all_sources() == ["chol_solve", "fused_gram",
                                        "fused_topk", "gram_table"]

    def test_build_without_nvcc_raises(self, monkeypatch):
        monkeypatch.setattr(_build.shutil, "which", lambda _: None)
        monkeypatch.setattr(_build.os, "access", lambda *_: False)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build(["fused_topk"])

    def test_build_dir_is_inside_the_checkout(self):
        root = Path(__file__).resolve().parents[1]
        assert _build.BUILD_ROOT == root / "build" / "torch_kernels"


# -- the launch's host-side cut: catalogue splits and the staging branch ----

SMS = ft.H100_SMS
ML20M_ITEMS = 26_744


class TestPlan:
    @pytest.mark.parametrize("itemsize", [1, 2, 4])
    @pytest.mark.parametrize("k", [1, 16, 128])
    @pytest.mark.parametrize("B", [1, 2, 8, 37, 64])
    def test_small_batches_fill_the_card(self, B, k, itemsize):
        plan = ft.topk_plan(B, ML20M_ITEMS, 64, itemsize, k, SMS)
        n_qblocks = -(-B // plan.qb)
        assert n_qblocks == 1 and plan.qb % 8 == 0 and plan.qb >= B
        # at least one block an SM: the catalogue has the tiles for it
        assert n_qblocks * plan.splits >= SMS
        assert plan.splits <= -(-ML20M_ITEMS // plan.chunk)
        assert plan.kp >= k and plan.kp & (plan.kp - 1) == 0
        assert plan.scratch_bytes == B * plan.splits * plan.kp * 8
        assert plan.scratch_bytes <= ft.TOPK_SCRATCH_CAP
        assert plan.smem_bytes <= ft.SMEM_LIMIT

    @pytest.mark.parametrize("itemsize", [1, 2, 4])
    @pytest.mark.parametrize("B", [64 * SMS, 64 * SMS + 1, 20_000])
    def test_one_split_where_the_batch_fills_the_card(self, B, itemsize):
        plan = ft.topk_plan(B, ML20M_ITEMS, 64, itemsize, 16, SMS)
        assert plan.qb == ft.TOPK_MAX_QB
        assert plan.splits == 1 and plan.scratch_bytes == 0

    @pytest.mark.parametrize("itemsize,k", [(1, 16), (2, 16), (4, 16),
                                            (1, 128), (4, 128)])
    def test_a_batch_sweep_stays_one_wave(self, itemsize, k):
        """B = 2048 is 32 query blocks: split so that every SM has a
        block, and no more blocks than are resident at once."""
        plan = ft.topk_plan(2048, ML20M_ITEMS, 64, itemsize, k, SMS)
        blocks = 32 * plan.splits
        resident = SMS * (2 if 2 * (plan.smem_bytes + 1024)
                          <= ft.SM_SMEM else 1)
        assert SMS - 32 < blocks <= resident
        assert plan.scratch_bytes <= ft.TOPK_SCRATCH_CAP

    @pytest.mark.parametrize("r,itemsize,aligned,vec16", [
        (64, 1, True, True), (64, 2, True, True), (64, 4, True, True),
        (10, 1, True, False), (10, 2, True, False), (10, 4, True, False),
        (48, 1, True, True), (24, 1, True, False), (8, 2, True, True),
        (12, 4, True, True), (33, 4, True, False), (64, 1, False, False)])
    def test_16_byte_copies_only_for_aligned_rows(self, r, itemsize,
                                                  aligned, vec16):
        plan = ft.topk_plan(8, 1000, r, itemsize, 16, SMS, aligned)
        assert plan.vec16 is vec16
        assert plan.staging == ("cp.async-16B" if vec16 else
                                "element-wise")

    @pytest.mark.parametrize("itemsize", [1, 2, 4])
    def test_wide_ranks_shrink_the_tile_not_the_limit(self, itemsize):
        plan = ft.topk_plan(64, ML20M_ITEMS, ft.TOPK_MAX_RANK, itemsize,
                            ft.TOPK_MAX_K, SMS)
        assert plan.smem_bytes <= ft.SMEM_LIMIT
        assert plan.chunk in (32, 64, 128) and plan.qb in range(8, 65, 8)
        assert plan.smem_bytes == ft.topk_smem_bytes(
            ft.TOPK_MAX_RANK * itemsize, plan.qb, plan.chunk,
            ft.TOPK_MAX_K)

    def test_a_tiny_catalogue_has_few_ranges(self):
        plan = ft.topk_plan(1, 100, 16, 4, 8, SMS)
        assert plan.splits == 1 and plan.scratch_bytes == 0
        plan = ft.topk_plan(1, 300, 16, 4, 8, SMS)
        assert plan.splits == 3  # one range a tile at most

    def test_scratch_cap_binds(self):
        plan = ft.topk_plan(4000, 10_000_000, 64, 1, 128, SMS)
        assert plan.splits >= 1
        assert plan.scratch_bytes <= ft.TOPK_SCRATCH_CAP


def partial_topk(user_table, idx, item_table, user_scale=None,
                 item_scale=None, base=None, *, k, n_items, splits, chunk):
    """The first pass as the kernel cuts it: the catalogue in ``splits``
    ranges of whole ``chunk``-row tiles, each range's best list ``[kp]``
    from the plain version, empty slots ``(-inf, EMPTY_ID)``."""
    kp = 1 << (k - 1).bit_length()
    n_rows = item_table.shape[0]
    n_chunks = -(-n_rows // chunk)
    base = int(base or 0)
    out_s, out_i = [], []
    for sx in range(splits):
        lo = (sx * n_chunks // splits) * chunk
        hi = min(((sx + 1) * n_chunks // splits) * chunk, n_rows)
        s, i = ft.fused_topk_reference(
            user_table, idx, item_table[lo:hi], user_scale,
            None if item_scale is None else item_scale.reshape(-1)[lo:hi],
            base + lo, k=min(kp, hi - lo), n_items=n_items)
        pad = kp - s.shape[1]
        out_s.append(torch.nn.functional.pad(s, (0, pad),
                                             value=float("-inf")))
        out_i.append(torch.nn.functional.pad(i, (0, pad),
                                             value=ft.EMPTY_ID))
    return torch.stack(out_s, 1), torch.stack(out_i, 1)


class TestMergePartial:
    """The second pass's plain version against one pass over the whole
    catalogue: exact, because (score desc, id asc) is a total order."""

    @pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
    @pytest.mark.parametrize("k,splits,chunk,base,n_items", [
        (8, 4, 32, None, 200), (16, 7, 16, 1000, 1150),
        (128, 3, 32, None, 200),    # k greater than a split's rows
        (5, 13, 16, 7, 150),        # masked tail, one tile a split
        (32, 1, 128, None, 200)])
    def test_matches_one_pass(self, wire, k, splits, chunk, base, n_items):
        U, V = make_tables(seed=k + splits)
        _, (tu, tv, tus, tvs) = wire_inputs(U, V, wire)
        idx = torch.arange(0, 60, 3, dtype=torch.int32)
        ps, pi = partial_topk(
            tu, idx, tv, tus, tvs, base, k=k, n_items=n_items,
            splits=splits, chunk=chunk)
        kp = 1 << (k - 1).bit_length()
        assert ps.shape == pi.shape == (20, splits, kp)
        s, i = ft.merge_partial_topk(ps, pi, k=k)
        rs, ri = ft.fused_topk_reference(tu, idx, tv, tus, tvs, base, k=k,
                                         n_items=n_items)
        assert torch.equal(i, ri) and torch.equal(s, rs)

    @pytest.mark.parametrize("k", [4, 16, 128])
    def test_ties_across_splits_go_to_the_lower_id(self, k):
        rng = np.random.default_rng(5)
        U = rng.integers(-1, 2, (30, 8)).astype(np.float32)
        V = rng.integers(-1, 2, (200, 8)).astype(np.float32)
        tu, tv = torch.from_numpy(U), torch.from_numpy(V)
        idx = torch.arange(30, dtype=torch.int32)
        ps, pi = partial_topk(tu, idx, tv, base=50, k=k,
                                           n_items=240, splits=5, chunk=32)
        s, i = ft.merge_partial_topk(ps, pi, k=k)
        rs, ri = ft.fused_topk_reference(tu, idx, tv, base=50, k=k,
                                         n_items=240)
        assert torch.equal(i, ri) and torch.equal(s, rs)
        same = s[:, 1:] == s[:, :-1]
        assert same.any() and bool((i[:, 1:] > i[:, :-1])[same].all())

    def test_empty_slots_come_out_as_minus_inf_and_zero(self):
        ps = torch.tensor([[[3.0, 1.0], [2.0, float("-inf")]]])
        pi = torch.tensor([[[4, 9], [7, ft.EMPTY_ID]]], dtype=torch.int32)
        s, i = ft.merge_partial_topk(ps, pi, k=4)
        assert s.tolist() == [[3.0, 2.0, 1.0, float("-inf")]]
        assert i.tolist() == [[4, 7, 9, 0]] and i.dtype == torch.int32

    def test_split_ranges_cover_the_catalogue_once(self):
        for n_rows in (1, 127, 128, 129, 26_744):
            for chunk in (32, 128):
                n = -(-n_rows // chunk)
                for S in {1, min(n, 2), min(n, 5), n}:
                    seen = np.zeros(n_rows, int)
                    for sx in range(S):
                        lo = (sx * n // S) * chunk
                        hi = min(((sx + 1) * n // S) * chunk, n_rows)
                        assert hi > lo
                        seen[lo:hi] += 1
                    assert (seen == 1).all(), (n_rows, chunk, S)
