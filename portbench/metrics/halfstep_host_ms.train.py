"""``halfstep_host_ms.train``: host milliseconds a half-step takes to
launch its row blocks (the program's ``als.halfstep.user`` and
``als.halfstep.item`` spans in ``models/als.py::train_als``), the mean
over the traced window; the card runs behind it."""

from portbench.harness.program_spans import durations


def read(run):
    d = durations(run, "als.halfstep.", prefix=True)
    return 1e3 * sum(d) / len(d) if d else None
