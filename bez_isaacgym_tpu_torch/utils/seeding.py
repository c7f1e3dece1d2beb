"""Run seeding (port of `bez_isaacgym_tpu/utils/seeding.py`; reference
parity: utils/utils.py:45-70 set_seed).

Seeds the host-side RNGs (Python, numpy) that planners and data tooling
use, and returns the run's root `torch.Generator` on its device.  Nothing
seeds torch's global generator: every draw of the port takes an explicit
generator, as every draw of the JAX package takes an explicit key.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_seed(seed: int = 42, device="cpu") -> torch.Generator:
    """Seed Python and numpy and return a generator on `device` seeded
    `seed`; `seed == -1` draws one (as the JAX function does)."""
    if seed == -1:
        seed = np.random.randint(0, 10000)
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return torch.Generator(device=device).manual_seed(seed)
