"""The port's benchmark: `python3 portbench/run.py --workload <cell> ...`.

See `portbench/README.md`.  Nothing here imports JAX or the JAX package;
only the drivers import the port, and `reference/` imports nothing of it.
"""
