"""Vectorized environment API (step/reset over batched tasks)."""
