"""``dase_ms.train``: the template engine's own milliseconds a training
(``controller/engine.py::Engine.train`` less its algorithm's ``train``:
reading the data source, the sanity checks, the preparator), from the
benchmark's host spans around both calls."""

from portbench.harness.readers import span_mean_ms


def read(run):
    eng = span_mean_ms(run, "train.engine")
    alg = span_mean_ms(run, "train.algorithm")
    if eng is None or alg is None:
        return None
    return eng - alg
