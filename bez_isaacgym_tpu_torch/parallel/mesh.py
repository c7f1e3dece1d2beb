"""The env axis over the ranks (port of `bez_isaacgym_tpu/parallel/mesh.py`).

The JAX package shards the env/solve batch over a 1-D device mesh and
replicates parameters.  Here the mesh is the process group: one rank per
shard, each on its device.

- `env_sharding(mesh)` lays a global batch out as JAX's `P("env")` does:
  rank r holds the contiguous rows [r * N / world, (r + 1) * N / world).
- `replicated(mesh)` checks that every rank holds rank 0's bits of a
  tree (one broadcast of all its leaves' bytes).
- `gather_env` rebuilds the global batch from the shards with one
  `all_reduce` over a zero-padded buffer (x + 0 is exact), since gloo has
  no `all_gather` for CUDA tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from bez_isaacgym_tpu_torch.parallel.distributed import rank_device
from bez_isaacgym_tpu_torch.tasks.base import tree_map

ENV_AXIS = "env"


@dataclass(frozen=True)
class Mesh:
    """This rank's place on the env axis: rank, world size, device, and
    the process group (None: one process, no collectives)."""

    rank: int
    world: int
    device: torch.device
    group: object = None


def env_mesh(device="cuda", group=None) -> Mesh:
    """The mesh of the initialized process group (the default group unless
    `group` is given), or a one-rank mesh without one."""
    if not dist.is_initialized():
        return Mesh(0, 1, torch.device(device))
    group = group if group is not None else dist.group.WORLD
    return Mesh(dist.get_rank(group), dist.get_world_size(group),
                rank_device(device), group)


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


class EnvSharding:
    """This rank's contiguous slice of a global batch's leading axis, put
    on the mesh's device."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def rows(self, n: int) -> slice:
        w, r = self.mesh.world, self.mesh.rank
        if n % w:
            raise ValueError(f"a batch of {n} does not split over {w} ranks")
        return slice(r * n // w, (r + 1) * n // w)

    def __call__(self, tree):
        return tree_map(lambda x: x[self.rows(x.shape[0])].to(
            self.mesh.device).contiguous(), tree)


def env_sharding(mesh: Mesh) -> EnvSharding:
    """Batch-axis sharding: the leading (ENV_AXIS) dim split across the
    ranks."""
    return EnvSharding(mesh)


def _bytes(leaves) -> torch.Tensor:
    return torch.cat([x.detach().contiguous().reshape(-1).view(torch.uint8)
                      for x in leaves])


class Replicated:
    """A tree (on this rank's device) that every rank holds bit for bit:
    the same seed on every rank gives the same state, and a rank that
    differs from rank 0 raises."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def check(self, tree, what: str = "tree") -> None:
        """Raise unless every rank holds rank 0's bits of `tree` (one
        broadcast of every leaf's bytes)."""
        if self.mesh.group is None:
            return
        mine = _bytes(_leaves(tree))
        theirs = mine.clone()
        dist.broadcast(theirs, dist.get_global_rank(self.mesh.group, 0),
                       group=self.mesh.group)
        if not torch.equal(mine, theirs):
            bad = int((mine != theirs).sum())
            raise RuntimeError(f"rank {self.mesh.rank}: {what} differs from "
                               f"rank 0's in {bad} of {mine.numel()} bytes")

    def __call__(self, tree, what: str = "tree"):
        self.check(tree, what)
        return tree


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def gather_env(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global batch (world * n, ...) from every rank's shard (n, ...):
    each rank writes its rows into a zero buffer and one all_reduce sums
    the buffers.  Adding zeros is exact, so the result holds every rank's
    bits (gloo has no all_gather for CUDA tensors)."""
    if mesh.group is None:
        return x
    n = x.shape[0]
    buf = torch.zeros((mesh.world * n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    buf[mesh.rank * n:(mesh.rank + 1) * n] = x
    dist.all_reduce(buf, group=mesh.group)
    return buf


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s generator in a run seeded `seed`: the
    first word of numpy's SeedSequence([seed, rank]).  It plays the part
    of JAX's `fold_in(key, axis_index)`: distinct per rank, the same on
    every run, and unrelated to the run's own generator (seeded `seed`)."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def rank_generator(seed: int, mesh: Mesh) -> torch.Generator:
    """This rank's generator (`rank_seed`) on its device: its exploration
    noise, minibatch permutations, auto-reset draws and MPC noise."""
    return torch.Generator(device=mesh.device).manual_seed(
        rank_seed(seed, mesh.rank))
