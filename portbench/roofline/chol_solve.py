"""``chol_solve`` (``csrc/chol_solve.cu``): a batch of SPD systems
``A x = b``, one Cholesky factorization and two triangular solves each.

Per system ``r^3 / 3 + 2 r^2`` operations; bytes: the lower triangle of
``A`` (all a Cholesky solve needs) and ``b`` read once, ``x`` written
once, in f32."""

KERNELS = ("chol_solve_regs", "chol_solve_smem")
PRECISION = "f32"


def ops(systems: int, rank: int) -> float:
    return float(systems) * (rank ** 3 / 3.0 + 2.0 * rank * rank)


def nbytes(systems: int, rank: int) -> float:
    return float(systems) * (rank * (rank + 1) // 2 + 2 * rank) * 4
