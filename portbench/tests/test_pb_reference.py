"""The plain references: the ALS reference against a dense loop of its
own equations, and each cell's check failing the lower-precision control
at the tiny sizes while the program passes."""

import numpy as np
import pytest

from portbench.harness import registry


def _dense_als(users, items, stars, n_u, n_i, rank, iters, reg, alpha,
               implicit, seed):
    """One row at a time, in numpy float64: the equations of the
    reference's docstring written out."""
    ref = registry.reference("als")
    u0, v0 = ref.initial_factors(seed, n_u, n_i, rank)
    U, V = u0.double().numpy(), v0.double().numpy()

    def half(fixed, rows, cols, n_rows):
        out = np.zeros((n_rows, rank))
        G = fixed.T @ fixed
        for x in range(n_rows):
            sel = rows == x
            if not sel.any():
                continue
            F = fixed[cols[sel]]
            r = stars[sel].astype(np.float64)
            if implicit:
                A = G + (F * (alpha * r)[:, None]).T @ F
                b = F.T @ (1.0 + alpha * r)
            else:
                A = F.T @ F
                b = F.T @ r
            A += (reg * sel.sum() + 1e-6) * np.eye(rank)
            out[x] = np.linalg.solve(A, b)
        return out

    for _ in range(iters):
        U = half(V, users, items, n_u)
        V = half(U, items, users, n_i)
    return U, V


@pytest.mark.parametrize("implicit", [False, True])
def test_reference_als_is_its_equations(implicit):
    rs = np.random.default_rng(0)
    n_u, n_i, nnz = 40, 25, 300
    key = rs.choice(n_u * n_i, nnz, replace=False)
    users, items = (key // n_i).astype(np.int32), (key % n_i).astype(np.int32)
    stars = rs.integers(1, 11, nnz).astype(np.float32) / 2
    ref = registry.reference("als")
    old = ref.SLOTS
    ref.SLOTS = 16  # many small blocks
    try:
        U, V = ref.train(users, items, stars, n_u, n_i, rank=4,
                         iterations=3, reg=0.05, alpha=2.0,
                         implicit=implicit, seed=9, device="cpu")
    finally:
        ref.SLOTS = old
    Ud, Vd = _dense_als(users, items, stars, n_u, n_i, 4, 3, 0.05, 2.0,
                        implicit, 9)
    np.testing.assert_allclose(U.numpy(), Ud, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(V.numpy(), Vd, rtol=1e-9, atol=1e-12)


def test_topk_reference_reads():
    ref = registry.reference("topk")
    rs = np.random.default_rng(1)
    U = rs.standard_normal((6, 4)).astype(np.float32)
    V = rs.standard_normal((30, 4)).astype(np.float32)
    users = np.array([0, 3, 5])
    S = U[users].astype(np.float64) @ V.T.astype(np.float64)
    ids = np.argsort(-S, axis=1)[:, :5]
    scores = np.take_along_axis(S, ids, 1).astype(np.float32)
    good = ref.judge(U, V, users, ids, scores, 5, "cpu")
    assert good["rank_gap"] == 0.0 and good["score_err"] < 1e-6
    swapped = ids.copy()
    swapped[1, [0, 4]] = swapped[1, [4, 0]]
    assert ref.judge(U, V, users, swapped, scores, 5, "cpu")["rank_gap"] > 0
    dup = ids.copy()
    dup[2, 1] = dup[2, 0]
    assert ref.judge(U, V, users, dup, scores, 5, "cpu")["rank_gap"] == \
        float("inf")
    out = ids.copy()
    out[0, 0] = 30
    assert ref.judge(U, V, users, out, scores, 5, "cpu")["score_err"] == \
        float("inf")


@pytest.mark.parametrize("name", ["ml20m-explicit.train",
                                  "ml20m-implicit.train",
                                  "ml20m-explicit.score-all"])
def test_the_control_fails_and_the_program_passes(run_module, tiny_cell,
                                                  name):
    cell = tiny_cell(name)
    sound = run_module.execute(cell, 101, 0.3, False, "cpu")
    control = run_module.execute(cell, 102, 0.3, False, "cpu",
                                 control=True)
    assert sound.correct, sound.checks
    assert not control.correct, control.checks
