"""``fused_gram_roofline.train``: the least time of ``fused_gram``'s work
over its device time in the traced window, percent. The work of an
iteration is both half-steps over the real ratings
(``roofline/fused_gram.py``)."""

from portbench.harness.readers import least, roofline_share
from portbench.harness.registry import roofline


def read(run):
    iters = run.tracer.work.get("iterations", 0)
    if iters <= 0:
        return None
    k = roofline("fused_gram")
    sh = run.shape
    r, nnz = int(sh["rank"]), int(sh["nnz"])
    per_iter = 0.0
    for rows_out, rows_read in ((sh["users_rated"], sh["items_rated"]),
                                (sh["items_rated"], sh["users_rated"])):
        per_iter += least(k.ops(nnz, r), k.nbytes(nnz, rows_out, rows_read, r),
                          k.PRECISION)
    return roofline_share(run, k.KERNELS, per_iter * iters)
