"""``engine_ms.train``: the template engine's own milliseconds a training
(the program's ``engine.train`` span less its ``engine.algorithm``
children: reading, the sanity checks, the preparator), the mean over the
traced window. The program's twin of ``dase_ms.train``."""

from portbench.harness.program_spans import spans


def read(run):
    kept = spans(run) or []
    algo = {}
    for r in kept:
        if r.name == "engine.algorithm":
            algo[r.parent] = algo.get(r.parent, 0.0) + r.end - r.start
    own = [r.end - r.start - algo.get(r.id, 0.0) for r in kept
           if r.name == "engine.train"]
    return 1e3 * sum(own) / len(own) if own else None
