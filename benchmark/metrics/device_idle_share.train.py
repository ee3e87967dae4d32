"""device_idle_share.train: the share of the traced sub-window of train
steps in which no device operation ran, %."""

from benchmark.trace import idle_share


def read(r):
    return idle_share(r)
