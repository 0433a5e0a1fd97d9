"""``topk_wait_ms.score``: host milliseconds a flush's resolve blocks on
the card's event (the program's ``topk.wait`` span inside
``topk.resolve``, ``models/als.py::_dispatch_topk_rows``), over the
``topk.resolve`` spans of the traced window."""

from portbench.harness.program_spans import per_ms


def read(run):
    return per_ms(run, ["topk.wait"], "topk.resolve")
