"""Frozen copy of the port's `solvers/` (see `portbench/reference/__init__.py`)."""
