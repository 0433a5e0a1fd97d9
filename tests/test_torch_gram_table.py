"""The port's ``gram_table`` against the JAX package's ``gram_table_pallas``.

The JAX kernel runs in interpret mode on the CPU, as
``tests/test_ops.py::test_gram_table_pallas_interpret`` runs it; the
port's wrapper takes its plain version for CPU tensors. Same inputs, made
with numpy from a seed. Tolerance: rtol 1e-4, atol 1e-4, the JAX test's
own (f32 sums in another order).

The CUDA kernel runs only on the card; here its launch plan
(``table_plan``), its shared-memory formulas and its arithmetic (a numpy
emulation of the TF32 split products, k-step by k-step) are held to
``ops/smem.py``, the source and the plain version.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops.gram import gram_table_pallas
from predictionio_tpu_torch.ops import _build, fused_gram, gram, smem


def inputs(m, r, B, L, seed=4):
    rng = np.random.default_rng(seed)
    tab = rng.standard_normal((m, r)).astype(np.float32)
    idx = rng.integers(0, m, (B, L)).astype(np.int32)
    wa = rng.random((B, L)).astype(np.float32)
    wb = rng.random((B, L)).astype(np.float32)
    return tab, idx, wa, wb


@pytest.mark.parametrize("m,r,B,L", [(200, 16, 21, 24), (300, 64, 9, 40)],
                         ids=["jax-test-shape", "rank-64"])
def test_matches_jax_kernel_in_interpret_mode(m, r, B, L):
    tab, idx, wa, wb = inputs(m, r, B, L)
    jA, jb = gram_table_pallas(jnp.asarray(tab), jnp.asarray(idx),
                               jnp.asarray(wa), jnp.asarray(wb),
                               interpret=True)
    A, b = gram.gram_table(*(torch.from_numpy(x) for x in (tab, idx, wa, wb)))
    assert A.dtype == b.dtype == torch.float32
    assert A.shape == (B, r, r) and b.shape == (B, r)
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-4,
                               atol=1e-4)


def test_padding_slots_count_nothing():
    """w = 0 slots are multiplied, not skipped, and add nothing."""
    tab, idx, wa, wb = inputs(50, 16, 6, 12, seed=1)
    wa[:, 7:] = 0.0
    wb[:, 7:] = 0.0
    t = torch.from_numpy
    A, b = gram.gram_table(t(tab), t(idx), t(wa), t(wb))
    A7, b7 = gram.gram_table(t(tab), t(np.ascontiguousarray(idx[:, :7])),
                             t(np.ascontiguousarray(wa[:, :7])),
                             t(np.ascontiguousarray(wb[:, :7])))
    np.testing.assert_allclose(A.numpy(), A7.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b.numpy(), b7.numpy(), rtol=1e-6, atol=1e-6)


def test_bf16_table_is_upcast_exactly():
    tab, idx, wa, wb = inputs(64, 32, 5, 10, seed=2)
    t16 = torch.from_numpy(tab).bfloat16()
    A, b = gram.gram_table(t16, torch.from_numpy(idx), torch.from_numpy(wa),
                           torch.from_numpy(wb))
    Ar, br = gram.gram_table_reference(t16.float(), torch.from_numpy(idx),
                                       torch.from_numpy(wa),
                                       torch.from_numpy(wb))
    assert torch.equal(A, Ar) and torch.equal(b, br)


def test_an_index_outside_the_table_is_a_zero_row():
    tab, idx, wa, wb = inputs(40, 8, 4, 9, seed=3)
    idx[0, 1], idx[1, 2], idx[2, 0] = -1, 40, 2 ** 30
    t = torch.from_numpy
    A, b = gram.gram_table(t(tab), t(idx), t(wa), t(wb))
    inside = (idx >= 0) & (idx < 40)
    A0, b0 = gram.gram_table(t(tab), t(np.where(inside, idx, 0)),
                             t(np.where(inside, wa, 0).astype(np.float32)),
                             t(np.where(inside, wb, 0).astype(np.float32)))
    assert torch.equal(A, A0) and torch.equal(b, b0)


def test_cpu_tensors_launch_nothing():
    before = gram.LAUNCHES
    tab, idx, wa, wb = inputs(20, 8, 3, 4)
    gram.gram_table(*(torch.from_numpy(x) for x in (tab, idx, wa, wb)))
    assert gram.LAUNCHES == before


def test_shape_mismatch_raises():
    tab, idx, wa, wb = inputs(20, 8, 3, 4)
    with pytest.raises(ValueError, match="one \\[B, L\\] shape"):
        gram.gram_table(torch.from_numpy(tab), torch.from_numpy(idx),
                        torch.from_numpy(wa[:, :2]), torch.from_numpy(wb))


def test_kernel_source_is_built_with_the_others():
    assert "gram_table" in _build.all_sources()
    src = (_build.CSRC / "gram_table.cu").read_text()
    assert "predictionio_tpu/ops/gram.py::_gram_table_kernel" in src
    # cp.async and sum_partials come from fused_gram's header, unchanged
    assert '#include "gram_tile.cuh"' in src
    assert "gram_tile::gram_row" not in src
    for entry in gram._ENTRY.values():
        assert f"GRAM_TABLE_ENTRY({entry}," in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "cvt.rna.tf32.f32" in src
    assert "__global__ void __launch_bounds__(max_threads(NS), 1)\n" \
        "gram_table_kernel(" in src


def test_gram_table_builds_with_its_own_flags(tmp_path, monkeypatch):
    """Its nvcc splits the optimization over every core; the flag is in
    its command and in its library's hash, and in no other source's."""
    monkeypatch.setattr(_build, "_root", tmp_path)
    cmds = []
    monkeypatch.setattr(_build.subprocess, "Popen",
                        lambda cmd, **kw: cmds.append(cmd))
    for name in ("gram_table", "fused_gram"):
        _build._start(name, "nvcc")
    assert "--split-compile=0" in cmds[0]
    assert "--split-compile=0" not in cmds[1]
    assert cmds[0][1:len(_build.NVCC_FLAGS) + 1] == list(_build.NVCC_FLAGS)
    flagged = _build._target("gram_table")
    monkeypatch.setattr(_build, "SOURCE_FLAGS", {})
    assert _build._target("gram_table") != flagged


def test_the_sources_constants_are_the_plans():
    src = (_build.CSRC / "gram_table.cu").read_text()
    assert re.search(r"constexpr int kGroup = (\d+);", src).group(1) \
        == str(smem.TABLE_GROUP)
    assert re.search(r"constexpr int kMaxBarrierWorkers = (\d+);",
                     src).group(1) == str(smem.TABLE_MAX_BARRIER_WORKERS)
    assert re.search(r"constexpr int kBuffers = (\d+);", src).group(1) \
        == str(smem.TABLE_BUFFERS)
    caps = re.search(r"return strips <= 2 \? (\d+) : strips <= 4 \? (\d+) "
                     r": (\d+);", src).groups()
    assert [int(c) for c in caps] == [smem.table_max_threads(s)
                                      for s in (2, 4, 8)]
    assert smem.table_max_threads(1) == 640
    assert smem.table_max_threads(3) == 512
    assert smem.table_max_threads(5) == 384
    # the entry's 17 arguments, as the wrapper binds them
    macro = re.search(r"extern \"C\" int NAME\((.*?)\)", src, re.S).group(1)
    assert len(macro.split(",")) == 17
    assert len(gram._ENTRY) == 2


# -- the launch plan ------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
def test_table_plan_over_its_grid(itemsize):
    """Path 1 exactly where the resident table fits the opt-in limit;
    never more threads than the strips' budget (and 1,024); the bytes
    ``ops/smem.py`` gives; splits bounded as ``gram_plan``'s."""
    optin = smem.SMEM_LIMIT
    for r in list(range(1, 129, 7)) + [64, 128]:
        strips = -(-r // 16)
        for m in (1, 300, 512, 806, 807, 2000, 26_744):
            for B in (1, 7, 131, 1320, 8192):
                for L in (1, 31, 512, 4096):
                    p = gram.table_plan(m, r, itemsize, B, L, 132, optin)
                    fits = smem.gram_resident_bytes(m, r, itemsize) <= optin
                    assert p.path == (1 if fits else 2)
                    assert p.threads == p.workers * p.warps * 32 <= 1024
                    assert p.threads <= smem.table_max_threads(strips)
                    assert p.warps == (strips + 1) // 2
                    assert p.smem_bytes == smem.gram_table_bytes(
                        p.path, m, r, itemsize, p.workers) <= optin
                    if p.path == 2 and p.warps > 1:
                        assert p.workers <= smem.TABLE_MAX_BARRIER_WORKERS
                    groups = -(-L // 32)
                    assert 1 <= p.splits <= max(1, min(
                        fused_gram.GRAM_MAX_SPLITS,
                        groups // fused_gram.GRAM_MIN_CHUNKS))
                    if B >= 132 * p.workers:
                        assert p.splits == 1
                    assert p.scratch_bytes == (
                        B * p.splits * (r * r + r) * 4 if p.splits > 1
                        else 0)
                    assert p.scratch_bytes <= fused_gram.GRAM_SCRATCH_CAP
                    assert 1 <= p.blocks <= 132
                    assert p.blocks * p.workers >= min(
                        B * p.splits, 132 * p.workers)
                    assert p.vec16 == ((r * itemsize) % 16 == 0)


def test_forcing_a_path():
    assert gram.table_plan(512, 64, 4, 8192, 512, path=2).path == 2
    assert gram.table_plan(512, 64, 4, 8192, 512, path=1).path == 1
    with pytest.raises(ValueError, match="does not fit"):
        gram.table_plan(26_744, 64, 4, 8192, 512, path=1)
    with pytest.raises(ValueError, match="path is 0"):
        gram.table_plan(512, 64, 4, 8192, 512, path=3)
    with pytest.raises(ValueError, match="rank 1..128"):
        gram.table_plan(512, 129, 4, 8192, 512)


def test_the_chip_cases_plans():
    """The shapes phase gram-table launches: the 512-row table resident
    at rank 64 (8 workers of 2 warps, 512 threads), the ML-20M item
    table through L2, rank 128 through L2 in f32 and resident in bf16."""
    p = gram.table_plan(512, 64, 4, 8192, 512)
    assert (p.path, p.workers, p.warps, p.threads, p.splits) \
        == (1, 8, 2, 512, 1)
    assert p.smem_bytes == 513 * 72 * 4
    p = gram.table_plan(26_744, 64, 4, 8192, 512)
    assert (p.path, p.workers, p.smem_bytes) == (2, 8, 8 * 2 * 32 * 72 * 4)
    for itemsize in (4, 2):
        assert gram.table_plan(512, 128, itemsize, 8192, 512).path \
            == (2 if itemsize == 4 else 1)
    p = gram.table_plan(26_744, 64, 4, 40, 2048)
    assert p.splits == 8 and p.scratch_bytes == 40 * 8 * (64 * 64 + 64) * 4


def test_smem_formula_and_launch_name_are_the_plans():
    spec = smem.KERNELS["gram_table"]
    assert spec["launch"] == "kern" and spec["source"] == "gram_table.cu"
    assert spec["args"] == ("path", "m", "r", "itemsize", "workers")
    src = (_build.CSRC / "gram_table.cu").read_text()
    assert "kern<<<blocks, threads, smem, stream>>>" in src
    assert "cudaFuncSetAttribute(\n      kern, " \
        "cudaFuncAttributeMaxDynamicSharedMemorySize" in src
    grid = set(spec["grid"]())
    for itemsize in (4, 2):
        for r in (1, 10, 16, 64, 100, 128):
            for m in (1, 2, 256, 512, 20_000):
                p = gram.table_plan(m, r, itemsize, 8192, 512)
                point = (p.path, m, r, itemsize, p.workers)
                assert spec["bytes"](point) == p.smem_bytes
                if p.path == 1:
                    assert p.smem_bytes == smem.gram_resident_bytes(
                        m, r, itemsize)
                    if m & (m - 1) == 0:
                        assert point in grid
                else:
                    assert (2, 1, r, itemsize, p.workers) in grid
                    assert spec["bytes"]((2, 1, r, itemsize, p.workers)) \
                        == p.smem_bytes
                    assert not spec["refuses"](point, p.smem_bytes)


# -- the kernel's arithmetic, emulated ----------------------------------------

def tf32(x):
    """``cvt.rna.tf32.f32``: the nearest value with 10 stored mantissa
    bits, ties away from zero, as an f32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    mag = ((u & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)) \
        & np.uint32(0xFFFFE000)
    return ((u & np.uint32(0x80000000)) | mag).view(np.float32)


def split(x):
    """big the nearest TF32 value; the f32 rest, of which the mma reads
    the leading 11 bits (the low 13 cut off)."""
    big = tf32(x)
    rest = np.ascontiguousarray((x - big).astype(np.float32)).view(np.uint32)
    return big, (rest & np.uint32(0xFFFFE000)).view(np.float32)


def emulate_row(F, wa, wb, exact_b, passes=3):
    """One row as the kernel multiplies it: ``F`` [L, r] the gathered rows
    (f32, zeros for an index outside the table), k-steps of 8 slots in
    order, each tile's ``mma`` an exact sum of its 8 products added to the
    f32 sums once (small_A big_B, big_A small_B, big_A big_B); b by f32
    FMAs a lane (slots t and t + 4 of each k-step) summed over the quad
    as the shuffles sum it. ``passes`` 1 keeps big_A big_B alone."""
    L, r = F.shape
    rp = -(-r // 16) * 16
    lp = -(-L // 8) * 8
    Fp = np.zeros((lp, rp), np.float32)
    Fp[:L, :r] = F
    wap = np.zeros(lp, np.float32)
    wbp = np.zeros(lp, np.float32)
    wap[:L], wbp[:L] = wa, wb
    X = (wap[:, None] * Fp).astype(np.float32)
    Ab, As = split(X)
    Bb, Bs = (Fp, np.zeros_like(Fp)) if exact_b else split(Fp)
    acc = np.zeros((rp, rp), np.float32)
    bq = np.zeros((4, rp), np.float32)  # the quad's lanes t = 0..3
    for k in range(0, lp, 8):
        sl = slice(k, k + 8)
        terms = ([(As, Bb), (Ab, Bs), (Ab, Bb)] if passes == 3
                 else [(Ab, Bb)])
        for a, b in terms:
            acc = (acc.astype(np.float64)
                   + a[sl].astype(np.float64).T @ b[sl].astype(np.float64)
                   ).astype(np.float32)
        for t in range(4):
            for s in (k + t, k + t + 4):
                bq[t] = (bq[t].astype(np.float64) + np.float64(wbp[s])
                         * Fp[s].astype(np.float64)).astype(np.float32)
    b = ((bq[0] + bq[1]) + (bq[2] + bq[3])).astype(np.float32)
    low = np.tril(acc[:r, :r])
    A = low + np.tril(low, -1).T
    return A, b[:r]


def check_gram_tolerance(A, b, Ar, br, fmax, wa, wb):
    """chip_smoke.py check_gram's limits: |dA| <= 1e-5 sum|wa| max|f|^2
    and |db| <= 1e-5 sum|wb| max|f| per row; returns the largest |dA|
    as a share of its row's limit."""
    share = 0.0
    for i in range(A.shape[0]):
        tolA = 1e-5 * np.abs(wa[i]).sum() * fmax * fmax
        tolb = 1e-5 * np.abs(wb[i]).sum() * fmax
        assert np.abs(A[i] - Ar[i]).max() <= tolA
        assert np.abs(b[i] - br[i]).max() <= tolb
        share = max(share, np.abs(A[i] - Ar[i]).max() / tolA)
    return share


@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("weights", ["random", "zero-one"])
@pytest.mark.parametrize("r", [1, 10, 16])
def test_emulated_products_hold_to_the_plain_version(wire, weights, r):
    """At the chip cases' statistics (an N(0, 1) table; random weights,
    or the ML-20M block's 0/1 wa with ratings in wb), indices outside the
    table and an L that is no multiple of 8: the split products land
    within check_gram's tolerance, and at least ten times inside it;
    where wa * f is no TF32 value, the one-pass product lands further
    off."""
    rng = np.random.default_rng(r + (7 if wire == "bf16" else 0))
    m, B, L = 300, 5, 75
    tab = rng.standard_normal((m, r), dtype=np.float32)
    if wire == "bf16":
        tab = torch.from_numpy(tab).bfloat16().float().numpy()
    idx = rng.integers(-3, m + 3, (B, L)).astype(np.int32)
    if weights == "random":
        wa = rng.random((B, L), dtype=np.float32)
        wb = rng.random((B, L), dtype=np.float32)
    else:
        wa = (rng.random((B, L)) < 0.8).astype(np.float32)
        wb = (wa * rng.integers(1, 11, (B, L)) / 2).astype(np.float32)
    outside = (idx < 0) | (idx >= m)
    F = np.where(outside[..., None], 0.0,
                 tab[np.clip(idx, 0, m - 1)]).astype(np.float32)
    # an index outside the table is a zero row: the plain version takes
    # a clipped index with no weight
    wa0 = np.where(outside, 0.0, wa).astype(np.float32)
    wb0 = np.where(outside, 0.0, wb).astype(np.float32)
    Ar, br = (x.numpy() for x in gram.gram_table_reference(
        *(torch.from_numpy(x) for x in (tab, np.clip(idx, 0, m - 1), wa0,
                                         wb0))))
    fmax = np.abs(tab).max()
    got = [emulate_row(F[i], wa[i], wb[i], wire == "bf16") for i in range(B)]
    A = np.stack([a for a, _ in got])
    b = np.stack([x for _, x in got])
    assert np.array_equal(A, A.transpose(0, 2, 1))
    share = check_gram_tolerance(A, b, Ar, br, fmax, wa, wb)
    assert share < 0.1
    one = np.stack([emulate_row(F[i], wa[i], wb[i], wire == "bf16",
                                passes=1)[0] for i in range(B)])
    if r > 1 and not (wire == "bf16" and weights == "zero-one"):
        assert np.abs(one - Ar).max() > np.abs(A - Ar).max()


def test_the_splits_of_tf32_are_exact_and_round_to_nearest():
    x = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                  -(1.0 + 2.0 ** -11), 3.14159265, -2.5e-8],
                 dtype=np.float32)
    big = tf32(x)
    assert big[0] == 1.0
    assert big[1] == 1.0 + 2.0 ** -10          # a tie goes away from zero
    assert big[2] == 1.0 + 2.0 ** -9
    assert big[3] == -(1.0 + 2.0 ** -10)
    assert not (big.view(np.uint32) & np.uint32(0x1FFF)).any()
    b, s = split(x)
    rest = x.astype(np.float64) - b - s
    assert (np.abs(rest) <= 2.0 ** -21 * np.abs(x)).all()
