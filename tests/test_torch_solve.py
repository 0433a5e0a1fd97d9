"""The port's batched SPD solve against the JAX package's.

The port runs on the CPU, so ``solve_spd_batch`` takes its plain column
loop; the JAX side runs its Pallas Cholesky in interpret mode at ranks
that cover both TPU variants (padded rank <= 88 scratch, <= 128 in
place), and its XLA route at r = 136. Tolerance: rtol 1e-4, atol 1e-5 on
well-conditioned systems (f32, the same algorithm; only rounding inside
``rsqrt`` and the sums may differ), against XLA's differently ordered
Cholesky rtol 2e-4. The CUDA kernel is held against the plain version on
the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import predictionio_tpu.ops.solve as jsolve
from predictionio_tpu_torch.ops import solve


def spd_batch(n, r, seed=0, reg=0.5):
    """Well-conditioned SPD systems (more rows than rank, plus reg)."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((n, 2 * r + 3, r)).astype(np.float32)
    A = np.einsum("nkr,nks->nrs", W, W).astype(np.float32) / (2 * r)
    A += reg * np.eye(r, dtype=np.float32)
    b = rng.standard_normal((n, r)).astype(np.float32)
    return A, b


@pytest.mark.parametrize("n,r", [(5, 3), (9, 8), (130, 10), (6, 64),
                                 (4, 96), (3, 128),
                                 # the kernel plan's boundaries
                                 (3, 16), (3, 32), (3, 33), (3, 48),
                                 (3, 63), (3, 65)])
def test_matches_jax_pallas_kernel(n, r):
    A, b = spd_batch(n, r, seed=r)
    x = solve.solve_spd_batch(torch.from_numpy(A), torch.from_numpy(b))
    assert x.shape == (n, r) and x.dtype == torch.float32
    Aj = jnp.asarray(A) + 1e-6 * jnp.eye(r, dtype=jnp.float32)
    want = np.asarray(jsolve._solve_spd_pallas(Aj, jnp.asarray(b),
                                               interpret=True))
    np.testing.assert_allclose(x.numpy(), want, rtol=1e-4, atol=1e-5)


def test_matches_jax_xla_route_past_rank_128():
    A, b = spd_batch(4, 136, seed=1)
    x = solve.solve_spd_batch(torch.from_numpy(A), torch.from_numpy(b))
    want = np.asarray(jsolve.solve_spd_batch(jnp.asarray(A),
                                             jnp.asarray(b)))
    np.testing.assert_allclose(x.numpy(), want, rtol=2e-4, atol=1e-5)


ROUTE_CASES = [(dt, r, dev) for dev in ("cpu", "cuda")
               for dt in (torch.float32, torch.float64, torch.bfloat16,
                          torch.float16)
               for r in (1, 64, 128, 129, 136)]


@pytest.mark.parametrize("dtype,rank,device_type", ROUTE_CASES,
                         ids=[f"{dev}-{str(dt)[6:]}-r{r}"
                              for dt, r, dev in ROUTE_CASES])
def test_solve_route(dtype, rank, device_type):
    """CPU systems take the plain loop; on the card f32 up to rank 128
    takes the kernel and every other system the library's Cholesky,
    never the plain loop."""
    want = ("plain" if device_type == "cpu" else
            "kernel" if dtype == torch.float32 and rank <= 128
            else "library")
    assert solve.solve_route(dtype, rank, device_type) == want


def test_solve_route_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        solve.solve_route(torch.float32, 64, "mps")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_library_route_matches_jax_xla_route_past_rank_128(dtype):
    """The route the card takes past rank 128 (and for non-f32 systems),
    run on CPU tensors: XLA's ``cho_factor`` / ``cho_solve`` is the
    reference's counterpart. It reads the lower triangle only."""
    A, b = spd_batch(4, 136, seed=3)
    At, bt = torch.from_numpy(A).to(dtype), torch.from_numpy(b).to(dtype)
    x = solve.solve_spd_library(At, bt)
    assert x.dtype == dtype and x.shape == (4, 136)
    want = np.asarray(jsolve.solve_spd_batch(
        jnp.asarray(At.float().numpy()), jnp.asarray(bt.float().numpy())))
    tol = 2e-4 if dtype != torch.bfloat16 else 2e-2
    np.testing.assert_allclose(x.float().numpy(), want, rtol=tol,
                               atol=tol / 10)
    upper = At.clone()
    iu = torch.triu_indices(136, 136, 1)
    upper[:, iu[0], iu[1]] = 7.0
    assert torch.equal(solve.solve_spd_library(upper, bt), x)


def test_float64_truth_and_leading_axes():
    A, b = spd_batch(12, 16, seed=2)
    x = solve.solve_spd_batch(torch.from_numpy(A).reshape(3, 4, 16, 16),
                              torch.from_numpy(b).reshape(3, 4, 16))
    assert x.shape == (3, 4, 16)
    A64 = A.astype(np.float64) + 1e-6 * np.eye(16)
    want = np.linalg.solve(A64, b.astype(np.float64)[..., None])[..., 0]
    np.testing.assert_allclose(x.reshape(12, 16).numpy(), want, rtol=1e-4,
                               atol=1e-5)
    x64 = solve.solve_spd_reference(torch.from_numpy(A).double(),
                                    torch.from_numpy(b).double())
    assert x64.dtype == torch.float64
    np.testing.assert_allclose(x64.numpy(), want, rtol=1e-10)


def test_reg_identity_with_zero_rhs_solves_to_exact_zero():
    """A row with no history: A = reg * I, b = 0 solves to exactly 0."""
    A = np.stack([0.01 * np.eye(8, dtype=np.float32)] * 3)
    x = solve.solve_spd_batch(torch.from_numpy(A), torch.zeros((3, 8)))
    assert torch.equal(x, torch.zeros((3, 8)))


def test_clamps_keep_a_singular_system_finite():
    """The pivot and division clamps of the TPU kernel: an all-zero
    matrix with jitter 0 and b = 0 gives exactly 0 where an unclamped
    Cholesky would divide 0 by 0, as the kernel does."""
    x = solve.solve_spd_batch(torch.zeros((2, 4, 4)), torch.zeros((2, 4)),
                              jitter=0.0)
    assert torch.equal(x, torch.zeros((2, 4)))
    want = np.asarray(jsolve._solve_spd_pallas(
        jnp.zeros((2, 4, 4)), jnp.zeros((2, 4)), interpret=True))
    np.testing.assert_array_equal(x.numpy(), want)


def test_does_not_modify_a_and_counts_nothing_on_cpu():
    A, b = spd_batch(6, 8)
    At = torch.from_numpy(A.copy())
    before = solve.LAUNCHES
    solve.solve_spd_batch(At, torch.from_numpy(b))
    assert torch.equal(At, torch.from_numpy(A))
    assert solve.LAUNCHES == before


def test_routes_by_dtype_and_rank():
    assert solve.CHOL_MAX_RANK == 128
    assert solve.kernel_takes(torch.zeros((1, 128, 128)))
    assert not solve.kernel_takes(torch.zeros((1, 129, 129)))
    assert not solve.kernel_takes(torch.zeros((1, 8, 8),
                                              dtype=torch.float64))
    with pytest.raises(ValueError, match="cuda or cpu"):
        solve.solve_spd_batch(torch.zeros((2, 4, 4), device="meta"),
                              torch.zeros((2, 4), device="meta"))
    with pytest.raises(ValueError, match="must be"):
        solve.solve_spd_batch(torch.zeros((2, 4, 4)), torch.zeros((2, 3)))


def test_kernel_source_agrees_with_wrapper():
    """The .cu constants and entry point are the ones the wrapper checks,
    plans and binds; every padded rank the plan returns has a launch;
    the launch raises the shared-memory limit wherever a plan needs more
    than 48 KB and reports the launch error; no block-wide barrier and no
    library solver."""
    import re

    from predictionio_tpu_torch.ops import _build

    src = (_build.CSRC / "chol_solve.cu").read_text()

    def const(name):
        return int(re.search(name + r" = (\d+)", src).group(1))

    assert const("kMaxRank") == solve.CHOL_MAX_RANK
    assert const("kRegMaxRank") == solve.CHOL_REG_MAX_RANK
    assert const("kChunk") == solve.CHOL_CHUNK
    assert const("kWarpsPerBlock") == solve.CHOL_WARPS_PER_BLOCK
    assert re.search(r'extern "C" int chol_solve_f32\(int device, const '
                     r'void\* A, const void\* b,\s+void\* x, int n, int r, '
                     r'int rp, int warps,\s+int vec16, long long smem_bytes, '
                     r'float jitter,\s+void\* stream\)', src)
    ranks = {solve.solve_plan(r, 4096).rank for r in range(1, 129)}
    assert ranks == {16, 32, 48, 64, 96, 128}
    for R in ranks:
        kernel = "chol_solve_regs" if R <= 64 else "chol_solve_smem"
        assert f"case {R}:\n      err = launch({kernel}<{R}>" in src
    big = [p for r in range(1, 129) for p in [solve.solve_plan(r, 4096)]
           if p.smem_bytes > 48 * 1024]
    assert big and "cudaFuncAttributeMaxDynamicSharedMemorySize" in src
    assert "if (smem > 48 * 1024)" in src
    assert "cudaGetLastError()" in src
    assert "__syncthreads" not in src and "bar.sync" not in src
    assert "cusolver" not in src.lower() and "cublas" not in src.lower()
    # the row map the tests hold is the one the kernel hard-codes
    assert "rhi = R - 1 - t" in src
    assert "m == 0 ? t : m == 1 ? R - 1 - t : m == 2 ? 32 + t : R - 33 - t" \
        in src


PADDED = (16, 32, 48, 64, 96, 128)


@pytest.mark.parametrize("n", [1, 39, 1724, 4096, 138493])
def test_solve_plan_every_rank(n):
    """For every rank 1..128: a padded rank >= r, registers up to 64 and
    shared memory past it, enough blocks for n systems, and a block's
    shared memory within the H100's 227 KB."""
    for r in range(1, 129):
        p = solve.solve_plan(r, n)
        assert p.rank >= r and p.rank in PADDED and p.rank == \
            solve.padded_rank(r)
        assert p.route == ("registers" if r <= 64 else "shared")
        assert p.lanes == len(solve.lane_rows(p.rank)) <= 32
        assert p.systems_per_warp * p.lanes <= 32
        assert 1 <= p.warps_per_block <= solve.CHOL_WARPS_PER_BLOCK
        per_block = p.systems_per_warp * p.warps_per_block
        assert p.blocks * per_block >= n > (p.blocks - 1) * per_block
        assert 0 < p.smem_bytes <= 232448  # an H100 block's 227 KB
        assert p.vec16 == (r % 4 == 0)
        assert not solve.solve_plan(r, n, aligned=False).vec16


def test_solve_plan_shapes_the_block_by_count():
    """A launch that would not give every SM a block takes fewer warps a
    block; rank 10 packs four systems a warp, rank 17 two."""
    assert solve.solve_plan(64, 138493).warps_per_block == 4
    assert solve.solve_plan(64, 39).warps_per_block == 1
    assert solve.solve_plan(64, 39).blocks == 39
    assert solve.solve_plan(10, 4096).systems_per_warp == 4
    assert solve.solve_plan(17, 4096).systems_per_warp == 2
    assert solve.solve_plan(33, 4096).systems_per_warp == 1
    assert solve.solve_plan(64, 1000, n_sm=8).warps_per_block == 4
    with pytest.raises(ValueError, match="rank"):
        solve.padded_rank(129)


@pytest.mark.parametrize("R", PADDED)
def test_lane_rows_cover_each_row_once(R):
    rows = [i for lane in solve.lane_rows(R) for i in lane]
    assert sorted(rows) == list(range(R))
    assert len({len(lane) for lane in solve.lane_rows(R)}) == 1


@pytest.mark.parametrize("R", PADDED)
def test_lane_rows_balance_every_column_step(R):
    """In column step k a lane updates its rows below k: no lane has more
    than one such row over another, nor more entries than one row's
    length over another."""
    lanes = solve.lane_rows(R)
    for k in range(R):
        n_rows = [sum(i > k for i in lane) for lane in lanes]
        entries = [sum(i - k for i in lane if i > k) for lane in lanes]
        assert max(n_rows) - min(n_rows) <= 1, k
        assert max(entries) - min(entries) <= R - 1 - k, k


@pytest.mark.parametrize("r", [5, 10, 33, 64, 100])
def test_plain_version_reads_only_the_lower_triangle(r):
    """Finite values above the diagonal give bit for bit the same x."""
    A, b = spd_batch(7, r, seed=r + 1)
    rng = np.random.default_rng(r)
    Au = A.copy()
    iu = np.triu_indices(r, 1)
    Au[:, iu[0], iu[1]] = rng.standard_normal((7, len(iu[0]))) * 10
    x = solve.solve_spd_reference(torch.from_numpy(A), torch.from_numpy(b))
    xu = solve.solve_spd_reference(torch.from_numpy(Au), torch.from_numpy(b))
    assert torch.equal(x, xu)


@pytest.mark.parametrize("r", [1, 10, 17, 33, 50, 64, 65, 100])
def test_identity_padding_to_the_plan_rank(r):
    """The kernel pads r to the plan's rank with identity rows and zeros
    in b. In the plain version the factor and the forward sweep are
    elementwise, and the padding feeds them exact zeros; its backward
    sweep sums each row with ``torch.sum``, whose grouping follows the
    row's length, so x agrees to the last bits and the padded part is
    exactly 0."""
    R = solve.solve_plan(r, 5).rank
    A, b = spd_batch(5, r, seed=3)
    Ap = np.zeros((5, R, R), np.float32) + np.eye(R, dtype=np.float32)
    Ap[:, :r, :r] = A
    bp = np.zeros((5, R), np.float32)
    bp[:, :r] = b
    x = solve.solve_spd_reference(torch.from_numpy(A), torch.from_numpy(b))
    xp = solve.solve_spd_reference(torch.from_numpy(Ap), torch.from_numpy(bp))
    assert torch.equal(xp[:, r:], torch.zeros((5, R - r)))
    np.testing.assert_allclose(xp[:, :r].numpy(), x.numpy(), rtol=1e-6,
                               atol=1e-7)


def _register_route(A, b, r, jitter=1e-6):
    """The register route's schedule in numpy, one system: lanes own
    ``lane_rows`` pairs, the step loop runs in phases of CHOL_CHUNK
    columns, the phase's chunk rotates one slot a step while the chunks
    right of it update in place, multipliers come from a by-row vector
    and a rotated one, the forward sweep rides along, and the backward
    sweep runs right-looking over the rows of L."""
    f32 = np.float32
    R = solve.padded_rank(r)
    W, lanes = solve.CHOL_CHUNK, solve.lane_rows(R)
    C, CL = R // W, R // W // 2
    M = np.eye(R, dtype=f32)
    M[:r, :r] = np.tril(A) + f32(jitter) * np.eye(r, dtype=f32)
    lo = np.stack([M[t, :R // 2] for t, _ in lanes])
    hi = np.stack([M[h] for _, h in lanes])
    t = np.arange(len(lanes))
    rl, rh = t, R - 1 - t
    bp = np.zeros(R, f32)
    bp[:r] = b
    acc_lo, acc_hi = bp[rl].copy(), bp[rh].copy()
    for P in range(C):
        kLo = P < CL
        for q in range(W):
            k = P * W + q
            ck_lo = lo[:, P * W] if kLo else np.zeros(len(t), f32)
            ck_hi = hi[:, P * W]
            own = k if kLo else R - 1 - k
            piv = (ck_lo if kLo else ck_hi)[own]
            inv = f32(1) / np.sqrt(max(piv, f32(1e-30)), dtype=f32)
            l_lo = np.where(kLo & (rl >= k), ck_lo * inv, 0).astype(f32)
            l_hi = np.where(rh >= k, ck_hi * inv, 0).astype(f32)
            yk = f32((acc_lo if kLo else acc_hi)[own]
                     / max(piv * inv, f32(1e-30)))
            if kLo:
                acc_lo = np.where(rl == k, yk, np.where(
                    rl > k, acc_lo - l_lo * yk, acc_lo)).astype(f32)
            acc_hi = np.where(rh == k, yk, np.where(
                rh > k, acc_hi - l_hi * yk, acc_hi)).astype(f32)
            v, rel = np.full(R, np.nan, f32), np.full(W, np.nan, f32)
            for i, li, lh, hrow in zip(rl, l_lo, l_hi, rh):
                if kLo:
                    v[i] = li
                    if i // W == P:
                        rel[(i - k) % W] = li
                elif hrow // W == P:
                    rel[(hrow - k) % W] = lh
                v[hrow] = lh
            for arr, l in ((lo, l_lo), (hi, l_hi)) if kLo else ((hi, l_hi),):
                arr[:, P * W:P * W + W - 1] = (arr[:, P * W + 1:P * W + W]
                                               - l[:, None] * rel[None, 1:])
                arr[:, P * W + W - 1] = l
            for c in range(P + 1, C):
                hi[:, c * W:c * W + W] -= l_hi[:, None] * v[None, c * W:c * W + W]
                if c < CL:
                    lo[:, c * W:c * W + W] -= (l_lo[:, None]
                                               * v[None, c * W:c * W + W])
    L = np.zeros((R, R), f32)
    L[rl, :R // 2], L[rh] = lo, hi
    assert np.isfinite(L).all() and not np.triu(L, 1).any()
    acc = np.zeros(R, f32)
    acc[rl], acc[rh] = acc_lo, acc_hi
    x = np.zeros(R, f32)
    for k in range(R - 1, -1, -1):
        x[k] = acc[k] / max(L[k, k], f32(1e-30))
        acc[:k] -= L[k, :k] * x[k]
    return x[:r]


@pytest.mark.parametrize("r", [3, 10, 16, 24, 40, 64])
def test_register_route_schedule_matches_plain(r):
    """The register route's rotating-chunk schedule, run in numpy on A
    with random values above the diagonal, solves the same systems as
    the plain version, and leaves L exactly 0 above the diagonal."""
    A, b = spd_batch(2, r, seed=200 + r)
    rng = np.random.default_rng(r)
    want = solve.solve_spd_reference(torch.from_numpy(A),
                                     torch.from_numpy(b)).numpy()
    for i in range(2):
        Au = A[i].copy()
        Au[np.triu_indices(r, 1)] = rng.standard_normal(r * (r - 1) // 2)
        np.testing.assert_allclose(_register_route(Au, b[i], r), want[i],
                                   rtol=1e-4, atol=1e-5)


def test_gramian_matches_jax():
    rng = np.random.default_rng(5)
    F = rng.normal(size=(40, 6)).astype(np.float32)
    np.testing.assert_allclose(
        solve.gramian(torch.from_numpy(F)).numpy(),
        np.asarray(jsolve.gramian(jnp.asarray(F))), rtol=1e-5, atol=1e-5)
    assert solve.gramian(torch.from_numpy(F).bfloat16()).dtype == \
        torch.float32
