"""The port's fused gather + Gramian against the JAX package's.

The port runs on the CPU, so ``fused_gram`` takes its plain version; the
JAX side runs its Pallas kernel in interpret mode (as
``tests/test_fused_gram.py`` does) and its jnp reference. Tolerance:
rtol 1e-5 on f32 (only the summation order differs); the bf16 wire gets
the same, because both sides round the table to bf16 identically and
upcast before every product. The CUDA kernel itself is held against the
plain version on the card by ``chip_smoke.py``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import predictionio_tpu.ops.fused_gram as jfg
import predictionio_tpu.ops.gram as jgram
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops import fused_gram as fg
from predictionio_tpu_torch.ops import gram


def make_problem(m=50, r=12, B=9, L=33, seed=0, zero_tail=True):
    rng = np.random.default_rng(seed)
    tab = rng.normal(size=(m, r)).astype(np.float32)
    idx = rng.integers(0, m, (B, L)).astype(np.int32)
    wa = rng.random((B, L)).astype(np.float32)
    wb = rng.normal(size=(B, L)).astype(np.float32)
    if zero_tail:  # padding slots: w = 0, a valid index
        wa[:, L - L // 3:] = 0
        wb[:, L - L // 3:] = 0
        wa[1:2] = 0
        wb[1:2] = 0
    return tab, idx, wa, wb


def tables(tab, wire):
    if wire == "f32":
        return torch.from_numpy(tab), jnp.asarray(tab)
    return (torch.from_numpy(tab).bfloat16(),
            jnp.asarray(tab).astype(jnp.bfloat16))


@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("B,L,chunk", [(9, 33, 16), (1, 7, None),
                                       (5, 48, 16), (13, 20, 8)])
def test_matches_jax_kernel_and_reference(wire, B, L, chunk):
    tab, idx, wa, wb = make_problem(B=B, L=L, seed=B + L)
    pt, jt = tables(tab, wire)
    A, b = fg.fused_gram(pt, torch.from_numpy(idx), torch.from_numpy(wa),
                         torch.from_numpy(wb))
    assert A.dtype == torch.float32 and A.shape == (B, 12, 12)
    assert b.dtype == torch.float32 and b.shape == (B, 12)
    jA, jb = jfg.fused_gram(jt, jnp.asarray(idx), jnp.asarray(wa),
                            jnp.asarray(wb), chunk=chunk, interpret=True)
    rA, rb = jfg.fused_gram_reference(jt, jnp.asarray(idx), jnp.asarray(wa),
                                      jnp.asarray(wb))
    for want_A, want_b in ((jA, jb), (rA, rb)):
        np.testing.assert_allclose(A.numpy(), np.asarray(want_A),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(b.numpy(), np.asarray(want_b),
                                   rtol=1e-5, atol=1e-5)
    # a row whose weights are all zero has exactly zero A and b
    if B > 1:
        assert not A[1].any() and not b[1].any()


def test_gram_weighted_matches_jax():
    rng = np.random.default_rng(4)
    F = rng.normal(size=(3, 5, 17, 6)).astype(np.float32)
    w = rng.random((3, 5, 17)).astype(np.float32)
    for bf16 in (False, True):
        got = gram.gram_weighted(torch.from_numpy(F), torch.from_numpy(w),
                                 bf16=bf16)
        want = jgram.gram_weighted(jnp.asarray(F), jnp.asarray(w),
                                   bf16=bf16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        for mode in ("einsum", "pair", "fused", "auto"):
            np.testing.assert_array_equal(
                gram.gram_dispatch(torch.from_numpy(F), torch.from_numpy(w),
                                   mode, bf16=bf16).numpy(), got.numpy())
    with pytest.raises(ValueError):
        gram.gram_dispatch(torch.from_numpy(F), torch.from_numpy(w), "nope")


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_lhs_fused_equals_einsum(wire):
    """``_lhs_fn``'s two realizations give the same normal equations on
    the same rows, over an extra leading axis."""
    tab, idx, wa, wb = make_problem(B=8, L=10, seed=3)
    pt, _ = tables(tab, wire)
    idx_t = torch.from_numpy(idx).reshape(2, 4, 10)
    wa_t = torch.from_numpy(wa).reshape(2, 4, 10)
    wb_t = torch.from_numpy(wb).reshape(2, 4, 10)
    Af, bf = als._lhs_fn(pt, idx_t, wa_t, wb_t, gram="fused", bf16=False)
    Ae, be = als._lhs_fn(pt, idx_t, wa_t, wb_t, gram="einsum", bf16=False)
    assert Af.shape == (2, 4, 12, 12) and bf.shape == (2, 4, 12)
    np.testing.assert_allclose(Af.numpy(), Ae.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bf.numpy(), be.numpy(), rtol=1e-5, atol=1e-5)
    As, bs = als._shadow_lhs_fn(torch.from_numpy(tab), idx_t, wa_t, wb_t,
                                gram="fused", bf16=False)
    Ab, bb = als._lhs_fn(torch.from_numpy(tab).bfloat16(), idx_t, wa_t,
                         wb_t, gram="fused", bf16=False)
    np.testing.assert_array_equal(As.numpy(), Ab.numpy())
    np.testing.assert_array_equal(bs.numpy(), bb.numpy())


def test_cpu_runs_the_plain_version_and_counts_nothing():
    tab, idx, wa, wb = make_problem()
    before = fg.LAUNCHES
    A, b = fg.fused_gram(torch.from_numpy(tab), torch.from_numpy(idx),
                         torch.from_numpy(wa), torch.from_numpy(wb))
    Ar, br = fg.fused_gram_reference(torch.from_numpy(tab),
                                     torch.from_numpy(idx),
                                     torch.from_numpy(wa),
                                     torch.from_numpy(wb))
    assert torch.equal(A, Ar) and torch.equal(b, br)
    assert fg.LAUNCHES == before


def test_a_cuda_request_without_cuda_raises(monkeypatch):
    """No silent CPU fallback: a device that is neither CPU nor CUDA
    raises, training asked for the card raises, and the kernel library
    cannot be had without ``nvcc``."""
    tab, idx, wa, wb = make_problem()
    meta = [torch.from_numpy(a).to("meta") for a in (tab, idx, wa, wb)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fg.fused_gram(*meta)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ratings = als.RatingsCOO(np.array([0, 1], np.int32),
                             np.array([1, 0], np.int32),
                             np.ones(2, np.float32), 2, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        als.train_als(ratings, als.ALSParams(rank=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        als.pack_ratings(ratings, als.ALSParams(rank=2))
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os, "access", lambda *_: False)
    monkeypatch.setattr(fg, "_lib", None)
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fg._kernel_lib()


def test_rank_limit_routes_auto_and_refuses_fused():
    assert fg.FUSED_GRAM_MAX_RANK == 128
    assert als.resolved_gram_mode(als.ALSParams(rank=128)) == "fused"
    assert als.resolved_gram_mode(als.ALSParams(rank=129)) == "einsum"
    assert als.resolved_gram_mode(als.ALSParams(rank=8,
                                                gram_mode="pair")) == "pair"
    tab = torch.zeros((4, 130))
    idx = torch.zeros((2, 3), dtype=torch.int32)
    w = torch.ones((2, 3))
    A, _ = als._lhs_fn(tab, idx, w, w, gram="auto", bf16=False)
    assert A.shape == (2, 130, 130)
    with pytest.raises(ValueError, match="rank <= 128"):
        als._lhs_fn(tab, idx, w, w, gram="fused", bf16=False)


def test_kernel_source_agrees_with_wrapper():
    """The .cu rank limit and C entry points are the ones the wrapper
    checks and binds; every output offset is 64-bit; gathers are
    asynchronous 16-byte copies and no sum is atomic."""
    src = "".join((_build.CSRC / name).read_text()
                  for name in ("fused_gram.cu", "gram_tile.cuh"))
    tile = int(re.search(r"kTile = (\d+)", src).group(1))
    side = int(re.search(r"kMaxSide = (\d+)", src).group(1))
    assert tile * side == fg.FUSED_GRAM_MAX_RANK
    assert int(re.search(r"kChunk = (\d+)", src).group(1)) == fg.GRAM_CHUNK
    # a thread per lower-triangle block of A and per 4 entries of b
    threads = int(re.search(r"kMaxThreads = (\d+)", src).group(1))
    assert side * (side + 1) // 2 + side <= threads <= 1024
    assert threads % 32 == 0
    for name in fg._ENTRY.values():
        assert f"FUSED_GRAM_ENTRY({name}," in src
    assert '#include "gram_tile.cuh"' in src
    assert "row * (size_t)r * (size_t)r" in src
    assert "cp.async.cg.shared.global" in src and "atomicAdd(" not in src
    assert "cublas" not in src.lower() and "#include <cu" in src


def test_argument_checks():
    tab, idx, wa, wb = (torch.from_numpy(a) for a in make_problem())
    with pytest.raises(ValueError, match="one \\[B, L\\] shape"):
        fg.fused_gram(tab, idx, wa[:, :5], wb)
    with pytest.raises(ValueError, match="\\[m, r\\]"):
        fg.fused_gram(tab[0], idx, wa, wb)


# -- the launch's host-side cut: L-splits and the staging branch ------------

SMS = fg.H100_SMS


@pytest.mark.parametrize("B,L", [(15, 131072), (52, 65536), (136, 32768),
                                 (1, 4096), (7, 20000), (100, 16384)])
def test_plan_splits_long_rows_to_fill_the_card(B, L):
    plan = fg.gram_plan(B, L, 64, 4, SMS)
    n_chunks = -(-L // fg.GRAM_CHUNK)
    assert plan.splits > 1
    assert plan.splits <= min(fg.GRAM_MAX_SPLITS,
                              n_chunks // fg.GRAM_MIN_CHUNKS)
    # at least one block an SM whenever the work allows it
    if B * min(fg.GRAM_MAX_SPLITS, n_chunks // fg.GRAM_MIN_CHUNKS) >= SMS:
        assert B * plan.splits >= SMS
    assert plan.scratch_bytes == B * plan.splits * (64 * 64 + 64) * 4
    assert plan.scratch_bytes <= fg.GRAM_SCRATCH_CAP


@pytest.mark.parametrize("B,L", [(8192, 512), (29002, 32), (528, 131072),
                                 (138493, 64), (3, 100), (0, 64)])
def test_plan_keeps_one_block_a_row(B, L):
    """Many rows fill the card alone; short rows have nothing to split."""
    plan = fg.gram_plan(B, L, 64, 4, SMS)
    assert plan.splits == 1 and plan.scratch_bytes == 0


def test_plan_scratch_cap_binds_at_high_rank():
    plan = fg.gram_plan(500, 1 << 16, 128, 4, SMS)
    assert 1 <= plan.splits < -(-fg.GRAM_BLOCKS_PER_SM * SMS // 500) + 1
    assert plan.scratch_bytes <= fg.GRAM_SCRATCH_CAP


@pytest.mark.parametrize("r,itemsize,aligned,vec16", [
    (64, 4, True, True), (64, 2, True, True), (10, 4, True, False),
    (10, 2, True, False), (12, 4, True, True), (12, 2, True, False),
    (8, 2, True, True), (64, 4, False, False), (1, 4, True, False)])
def test_plan_takes_16_byte_copies_only_for_aligned_rows(r, itemsize,
                                                         aligned, vec16):
    plan = fg.gram_plan(100, 64, r, itemsize, SMS, aligned)
    assert plan.vec16 is vec16
    assert plan.staging == ("cp.async-16B" if vec16 else "element-wise")


@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("L,splits", [(33, 1), (100, 2), (257, 3),
                                      (64, 2), (1000, 7)])
def test_split_sum_matches_the_plain_version(wire, L, splits):
    """Cutting a row's slots into ranges of whole chunks and adding the
    partial sums in order is the same function (f32 sums in another
    order: rtol 1e-5 of the sum of magnitudes)."""
    tab, idx, wa, wb = make_problem(m=40, r=10, B=6, L=L, seed=L)
    pt, _ = tables(tab, wire)
    args = (pt, torch.from_numpy(idx), torch.from_numpy(wa),
            torch.from_numpy(wb))
    A, b = fg.split_gram_reference(*args, splits=splits)
    Ar, br = fg.fused_gram_reference(*args)
    fmax = float(np.abs(tab).max())
    tolA = 1e-5 * np.abs(wa).sum(1) * fmax * fmax + 1e-30
    tolb = 1e-5 * np.abs(wb).sum(1) * fmax + 1e-30
    assert ((A - Ar).abs().amax(dim=(1, 2)).numpy() <= tolA).all()
    assert ((b - br).abs().amax(dim=1).numpy() <= tolb).all()
    if splits == 1:
        assert torch.equal(A, Ar) and torch.equal(b, br)
    # deterministic: the same cut gives the same bits
    A2, b2 = fg.split_gram_reference(*args, splits=splits)
    assert torch.equal(A, A2) and torch.equal(b, b2)


def test_split_covers_every_slot_once():
    """The kernel's cut (whole chunks, range s = [s n / S, (s + 1) n / S))
    leaves no slot out and counts none twice, ragged last chunk and all."""
    for L in (1, 31, 32, 33, 1000, 4097):
        n = -(-L // fg.GRAM_CHUNK)
        for S in (1, 2, 3, min(n, 7)):
            S = max(1, min(S, n))
            seen = np.zeros(L, int)
            for s in range(S):
                lo = (s * n // S) * fg.GRAM_CHUNK
                hi = min(((s + 1) * n // S) * fg.GRAM_CHUNK, L)
                seen[lo:hi] += 1
            assert (seen == 1).all(), (L, S)
