"""``topk_staging_ms.score``: host milliseconds a flush spends staging
through pinned memory (the program's ``topk.stage`` span, the ids to the
card, and ``topk.readback``, the pinned outputs, their two copies and the
event, in ``models/als.py::_dispatch_topk_rows``), over the
``topk.dispatch`` spans of the traced window."""

from portbench.harness.program_spans import per_ms


def read(run):
    return per_ms(run, ["topk.stage", "topk.readback"], "topk.dispatch")
