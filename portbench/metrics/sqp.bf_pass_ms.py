"""Time of the SQP's Riccati backward pass and line-search rollouts,
`SQPSolver._bf_pass` (solvers/sqp.py, solvers/riccati.py): CUDA-event
span, mean per tick."""

from portbench.readings import span_mean


def read(run):
    return span_mean(run, "sqp_bf_pass")
