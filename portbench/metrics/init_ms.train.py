"""``init_ms.train``: host milliseconds a training spends drawing its
initial factors and copying them to the card (the program's ``als.init``
span in ``models/als.py::train_als``: ``als.init.draw``, the seeded
``torch.randn`` on the host, and ``als.init.upload``), while the card
sits idle; over the ``engine.train`` spans of the traced window."""

from portbench.harness.program_spans import per_ms


def read(run):
    return per_ms(run, ["als.init"], "engine.train")
