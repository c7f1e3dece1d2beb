"""The device's idle share of a tick, %."""

from portbench.readings import idle_share


def read(run):
    return idle_share(run)
