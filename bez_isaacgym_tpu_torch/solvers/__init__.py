"""MPC solvers (MPPI)."""
