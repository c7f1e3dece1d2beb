"""Time of the SQP's linearization along the nominal,
`SQPSolver._lin_dyn` (solvers/sqp.py: forward mode through the plain
engine): CUDA-event span, mean per tick."""

from portbench.readings import span_mean


def read(run):
    return span_mean(run, "sqp_linearize")
