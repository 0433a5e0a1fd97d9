"""``mfu.train``: the useful operations of the iterations in the traced
window over what the f32 peak (67 TFLOP/s, outside the tensor cores: the
products run in f32) would do in it, percent. Useful: both half-steps'
real ratings (``fused_gram``'s count), every solved system
(``chol_solve``'s), and for implicit feedback each half-step's Gramian
of the fixed table, ``2 n r^2``."""

from portbench.harness.readers import mfu
from portbench.harness.registry import roofline


def read(run):
    iters = run.tracer.work.get("iterations", 0)
    if iters <= 0:
        return None
    sh = run.shape
    r, nnz = int(sh["rank"]), int(sh["nnz"])
    per_iter = 2 * roofline("fused_gram").ops(nnz, r)
    per_iter += roofline("chol_solve").ops(
        sh["users_rated"] + sh["items_rated"], r)
    if sh["implicit"]:
        per_iter += 2.0 * r * r * (sh["n_users"] + sh["n_items"])
    return mfu(run, per_iter * iters)
