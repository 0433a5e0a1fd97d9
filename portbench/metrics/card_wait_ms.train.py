"""``card_wait_ms.train``: host milliseconds a training waits for the
card to finish its queued iterations (the program's ``als.wait`` span
around the synchronize in ``templates/recommendation.py::ALSAlgorithm.
train``), over the ``engine.train`` spans of the traced window."""

from portbench.harness.program_spans import per_ms


def read(run):
    return per_ms(run, ["als.wait"], "engine.train")
