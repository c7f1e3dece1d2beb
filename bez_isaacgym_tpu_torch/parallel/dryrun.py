"""One data-parallel PPO iteration at tiny shapes over N spawned ranks
(the port's counterpart of `__graft_entry__.py::dryrun_multichip`).

    python -m bez_isaacgym_tpu_torch.parallel.dryrun 2 cuda
"""

from __future__ import annotations

import math
import sys

import torch

from bez_isaacgym_tpu_torch.parallel.distributed import (init_distributed,
                                                         spawn_ranks)


def _rank(rank: int, device: str) -> dict:
    from bez_isaacgym_tpu_torch.parallel.dp import data_parallel_ppo
    from bez_isaacgym_tpu_torch.parallel.mesh import (env_mesh, env_sharding,
                                                      rank_generator,
                                                      replicated)
    from bez_isaacgym_tpu_torch.rl.ppo import PPOConfig
    from bez_isaacgym_tpu_torch.tasks.base import TaskConfig
    from bez_isaacgym_tpu_torch.tasks.kick import KickTask

    init_distributed(device=device)
    mesh = env_mesh(device)
    num_envs = 2 * mesh.world
    task = KickTask(TaskConfig(substeps=2), device=mesh.device)
    cfg = PPOConfig(horizon=3, minibatch_size=num_envs * 3, mini_epochs=1,
                    units=(32, 32))
    dp = data_parallel_ppo(task, num_envs, mesh, cfg)
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    ts = dp.init(gen)
    env_state = task.reset(gen, num_envs)
    obs = torch.zeros((num_envs, task.num_obs), device=mesh.device)
    shard = env_sharding(mesh)
    ts, _, _, metrics = dp.train_iter(ts, shard(env_state), shard(obs),
                                      rank_generator(1, mesh))
    replicated(mesh).check((ts.params, ts.opt_state, ts.obs_rms,
                            ts.value_rms, ts.lr), "the trained TrainState")
    return {k: float(v) for k, v in metrics.items()}


def dryrun_multichip(n_ranks: int = 2, device: str = "cuda") -> dict:
    """Run ONE data-parallel PPO iteration (rollout + update) over
    `n_ranks` spawned ranks on `device` (each rank's card, or the CPU):
    2 envs per rank, horizon 3, units (32, 32).  Raises unless every
    metric is finite and the ranks' train states are bit-identical;
    returns rank 0's metrics."""
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip on cuda needs a CUDA device; "
                           "pass device='cpu' to run on the CPU")
    metrics = spawn_ranks(_rank, n_ranks, device)
    assert all(m == metrics[0] for m in metrics), metrics
    assert all(math.isfinite(v) for v in metrics[0].values()), metrics[0]
    print("dryrun_multichip ok:", metrics[0])
    return metrics[0]


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2,
                     sys.argv[2] if len(sys.argv) > 2 else "cuda")
