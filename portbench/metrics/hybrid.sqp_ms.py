"""Time of the hybrid's SQP stage, `SQPSolver.solve` (solvers/sqp.py,
solvers/riccati.py): CUDA-event span, mean per tick."""

from portbench.readings import span_mean


def read(run):
    return span_mean(run, "sqp")
