"""``mfu.score``: the scoring operations of the traced flushes (``2 B I
r`` each) over what the f32 peak would do in the traced window,
percent."""

from portbench.harness.readers import mfu
from portbench.harness.registry import roofline


def read(run):
    rows = run.tracer.work.get("users", 0)
    if rows <= 0:
        return None
    sh = run.shape
    return mfu(run, roofline("fused_topk").ops(rows, int(sh["n_items"]),
                                               int(sh["rank"])))
