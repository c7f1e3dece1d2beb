"""Utilities: checkpoint reading, spaces."""
