"""Seeded inputs: every draw of a run comes from `--seed` through here.

Each purpose (the resets, the MPPI noise, the rollout noise, the minibatch
permutations, the weights, the ticks the check samples) gets its own stream,
so that one stream's draws never shift another's.
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch


def subseed(seed: int, purpose: str) -> int:
    """A 63-bit seed for `purpose` from the run's seed (any integer)."""
    tag = int.from_bytes(purpose.encode(), "little")
    state = np.random.SeedSequence([seed % 2**64, tag]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, purpose: str, device) -> torch.Generator:
    """A torch generator on `device` for `purpose`."""
    return torch.Generator(device=device).manual_seed(subseed(seed, purpose))


def lecun_mlp(sizes: list[tuple[int, int]], gen: torch.Generator,
              device) -> list[torch.Tensor]:
    """Weights (out, in) for the given (in, out) layer sizes, LeCun-normal
    truncated at two deviations as flax draws them, from one draw on the
    device."""
    total = sum(a * b for a, b in sizes)
    z = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    out, at = [], 0
    for n_in, n_out in sizes:
        std = math.sqrt(1.0 / n_in) / .87962566103423978
        out.append((z[at:at + n_in * n_out] * std).reshape(n_out, n_in))
        at += n_in * n_out
    return out


class Sampler:
    """A uniform sample of `k` of the ticks of a window whose length is not
    known in advance (reservoir sampling, drawn from the seed).

    `slot(i)` says where tick i's record goes (None: not kept); call it for
    i = 0, 1, 2, ... in order."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(subseed(seed, "check_sample"))
        self.records: list = [None] * k

    def slot(self, i: int) -> int | None:
        if i < self.k:
            return i
        j = self.rng.randint(0, i)
        return j if j < self.k else None

    def kept(self) -> list:
        return [r for r in self.records if r is not None]
