"""device_idle_share.likelihood: the share of the traced test batch in which
no device operation ran, %."""

from benchmark.trace import idle_share


def read(r):
    return idle_share(r)
