"""Frozen copy of the port's `ops/` (see `portbench/reference/__init__.py`)."""
