"""The substep kernel's share of its least time (csrc/substep.cu), %."""

from portbench.readings import substep_roofline


def read(run):
    return substep_roofline(run)
