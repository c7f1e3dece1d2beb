"""Data parallelism over torch.distributed ranks: the env axis sharded,
gradients averaged (port of `bez_isaacgym_tpu/parallel/`).

The JAX package shards over a device mesh with XLA collectives; here each
rank is one process on its device (`torchrun`, or `spawn_ranks` on one
host), and the collectives are `torch.distributed` all_reduces and
broadcasts (NCCL with a card per rank, gloo when ranks share a card or on
the CPU).
"""

from bez_isaacgym_tpu_torch.parallel.mesh import (env_mesh,  # noqa: F401
                                                  env_sharding, replicated)
from bez_isaacgym_tpu_torch.parallel.dp import data_parallel_ppo  # noqa: F401
