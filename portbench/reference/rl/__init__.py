"""Frozen copy of the port's `rl/` (see `portbench/reference/__init__.py`)."""
