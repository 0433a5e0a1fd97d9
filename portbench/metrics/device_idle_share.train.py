"""``device_idle_share.train``: the share of the traced window in which
no operation ran on the card (the union of the profiler's device
intervals), percent."""

from portbench.harness.readers import idle_share


def read(run):
    return idle_share(run)
