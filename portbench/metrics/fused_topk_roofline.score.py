"""``fused_topk_roofline.score``: the least time of the traced flushes'
scoring (``roofline/fused_topk.py``: operations at the f32 peak, or
bytes) over ``fused_topk``'s device time, percent. Every flush is bound
by its operations, so the totals' bound is the sum of the flushes'."""

from portbench.harness.readers import least, roofline_share
from portbench.harness.registry import roofline


def _kp(num: int) -> int:
    k = 1
    while k < num:
        k *= 2
    return k


def read(run):
    w = run.tracer.work
    rows, flushes = w.get("users", 0), w.get("flushes", 0)
    if rows <= 0:
        return None
    sh = run.shape
    k = roofline("fused_topk")
    n_items, r = int(sh["n_items"]), int(sh["rank"])
    precision = "f32" if sh["itemsize"] == 4 else "bf16"
    t = least(k.ops(rows, n_items, r),
              k.nbytes(rows, flushes, n_items, r, _kp(int(sh["num"])),
                       int(sh["itemsize"])), precision)
    return roofline_share(run, k.KERNELS, t)
