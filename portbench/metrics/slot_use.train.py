"""``slot_use.train``: the share of the slots the half-steps gather that
hold a rating, percent (the program's counters ``als.slots_real`` over
``als.slots_padded``, counted once a half-step in ``models/als.py`` from
the packing's host integers), over the traced window."""

from portbench.harness.program_spans import counts


def read(run):
    c = counts(run) or {}
    real, padded = c.get("als.slots_real", 0), c.get("als.slots_padded", 0)
    return 100.0 * real / padded if padded > 0 else None
