"""Minimal space descriptions (Box), without a gym dependency.

Copy of `bez_isaacgym_tpu/utils/spaces.py`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Box:
    low: np.ndarray
    high: np.ndarray

    @property
    def shape(self):
        return np.shape(self.low)

    @staticmethod
    def symmetric(limit: float, n: int) -> "Box":
        return Box(low=np.full(n, -limit, np.float32),
                   high=np.full(n, limit, np.float32))

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return bool(np.all(x >= self.low) and np.all(x <= self.high))
