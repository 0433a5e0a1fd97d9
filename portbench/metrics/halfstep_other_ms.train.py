"""``halfstep_other_ms.train``: device milliseconds an iteration in
operations other than ``fused_gram`` and ``chol_solve`` (weights, the
regularization, row writes, the implicit Gramian, copies), from the
traced window."""

from portbench.harness.registry import roofline


def read(run):
    s, iters = run.summary, run.tracer.work.get("iterations", 0)
    if s is None or iters <= 0:
        return None
    gram = s.seconds_of(roofline("fused_gram").KERNELS)
    chol = s.seconds_of(roofline("chol_solve").KERNELS)
    if gram <= 0 or chol <= 0:
        return None
    return 1e3 * (s.device_s - gram - chol) / iters
