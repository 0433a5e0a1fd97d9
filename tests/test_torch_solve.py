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
                                 (4, 96), (3, 128)])
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
    """The .cu rank limit and entry point are the ones the wrapper checks
    and binds; the launch raises the shared-memory limit it needs past
    48 KB and reports the launch error."""
    import re

    from predictionio_tpu_torch.ops import _build

    src = (_build.CSRC / "chol_solve.cu").read_text()
    assert int(re.search(r"kMaxRank = (\d+)", src).group(1)) == \
        solve.CHOL_MAX_RANK
    assert 'extern "C" int chol_solve_f32(' in src
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src
    assert "cudaGetLastError()" in src
    assert "cusolver" not in src.lower() and "cublas" not in src.lower()


def test_gramian_matches_jax():
    rng = np.random.default_rng(5)
    F = rng.normal(size=(40, 6)).astype(np.float32)
    np.testing.assert_allclose(
        solve.gramian(torch.from_numpy(F)).numpy(),
        np.asarray(jsolve.gramian(jnp.asarray(F))), rtol=1e-5, atol=1e-5)
    assert solve.gramian(torch.from_numpy(F).bfloat16()).dtype == \
        torch.float32
