"""Frozen copy of the port's `tasks/` (see `portbench/reference/__init__.py`)."""
