"""Time of one `MPPISolver.solve` (solvers/mppi.py): CUDA-event span,
mean per tick."""

from portbench.readings import span_mean


def read(run):
    return span_mean(run, "solve")
