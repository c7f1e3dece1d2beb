"""Per-layer metric readers, one file each, named as the metric: each has
`read(run) -> float | None` (`portbench/harness.py::Run`)."""
