"""``chol_solve_roofline.train``: the least time of ``chol_solve``'s
systems over its device time in the traced window, percent. An iteration
solves each rated user's and each rated item's system once."""

from portbench.harness.readers import least, roofline_share
from portbench.harness.registry import roofline


def read(run):
    iters = run.tracer.work.get("iterations", 0)
    if iters <= 0:
        return None
    k = roofline("chol_solve")
    r = int(run.shape["rank"])
    per_iter = sum(least(k.ops(n, r), k.nbytes(n, r), k.PRECISION)
                   for n in (run.shape["users_rated"],
                             run.shape["items_rated"]))
    return roofline_share(run, k.KERNELS, per_iter * iters)
