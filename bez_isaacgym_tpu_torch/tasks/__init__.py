"""Tasks: batched env machinery (base), domain randomization, kick."""
