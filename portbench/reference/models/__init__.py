"""Frozen copy of the port's `models/` (see `portbench/reference/__init__.py`)."""
