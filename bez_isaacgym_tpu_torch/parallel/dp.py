"""Data-parallel PPO over the ranks of a process group (port of
`bez_isaacgym_tpu/parallel/dp.py`; the reference's Horovod allreduce,
rlgames_utils.py:71-81).

Each rank steps its shard of the env batch through the task (the substep
kernel on a card) and computes its gradients; the collectives of
`rl/ppo.py` (its `group`) average the running stats' moments, the
advantages' moments, and each minibatch's gradients and KL, and the
iteration's metrics are averaged at the end, as the JAX `shard_map`'s
pmeans do.  The train state stays bit-identical on every rank.

Draws: the run's generator (seeded `seed`, the same on every rank) makes
the initial TrainState and the reset of all `num_envs` envs, which each
rank then slices (`Runner`).  Each rank's rollout noise, minibatch
permutations and auto-reset draws come from its own generator,
`parallel/mesh.py::rank_generator(seed, mesh)`: the counterpart of JAX's
`fold_in(key, axis_index)`.
"""

from __future__ import annotations

import dataclasses

from bez_isaacgym_tpu_torch.parallel.mesh import Mesh, replicated
from bez_isaacgym_tpu_torch.rl.ppo import PPO, PPOConfig, pmean_flat
from bez_isaacgym_tpu_torch.rl.ppo_rnn import PPORNN
from bez_isaacgym_tpu_torch.tasks.base import BezTask


class DataParallelPPO:
    """PPO (or recurrent PPO) on this rank's `num_envs / world` envs.

    `ppo` is the rank's `PPO` / `PPORNN` with the group's collectives;
    `init` returns a TrainState checked to be every rank's; `train_iter`
    takes and returns this rank's shard (env states, observations, LSTM
    carry) and returns the metrics averaged over the ranks.
    """

    def __init__(self, task: BezTask, num_envs: int, mesh: Mesh,
                 cfg: PPOConfig = PPOConfig()):
        if num_envs % mesh.world:
            raise ValueError(f"num_envs {num_envs} does not split over "
                             f"{mesh.world} ranks")
        self.mesh = mesh
        # The global minibatch stays cfg.minibatch_size.
        local_cfg = dataclasses.replace(
            cfg, minibatch_size=max(1, cfg.minibatch_size // mesh.world))
        self.ppo = (PPORNN if cfg.rnn_units > 0 else PPO)(
            task, num_envs // mesh.world, local_cfg, group=mesh.group)

    def init(self, gen):
        """A fresh TrainState from `gen` (the run's generator, seeded alike
        on every rank), checked once to be bit-identical on every rank."""
        return replicated(self.mesh)(self.ppo.init(gen), "the TrainState")

    def check(self, ts):
        """A restored TrainState on this rank's device, checked to be
        every rank's."""
        return replicated(self.mesh)(self.ppo.check(ts), "the TrainState")

    def initial_carry(self):
        return self.ppo.initial_carry()

    def train_iter(self, ts, *shard_and_gen, noise=None, perms=None):
        """One iteration on this rank's shard: (ts, env_state, obs[, carry],
        gen) -> (ts, env_state, obs[, carry], metrics); `noise` and
        `perms` are this rank's draws when given."""
        *out, metrics = self.ppo.train_iter(ts, *shard_and_gen, noise=noise,
                                            perms=perms)
        if self.mesh.group is not None:
            # Every metric's pmean, in one all_reduce.
            metrics = dict(zip(metrics, pmean_flat(list(metrics.values()),
                                                   self.mesh.group)))
        return (*out, metrics)


def data_parallel_ppo(task: BezTask, num_envs: int, mesh: Mesh,
                      cfg: PPOConfig = PPOConfig()) -> DataParallelPPO:
    """PPO with the env axis sharded over `mesh`'s ranks and gradients
    averaged per minibatch.  num_envs is the *global* env count; it must
    divide by the number of ranks, and each rank's minibatch is
    cfg.minibatch_size / ranks.  The task (and so the run) is on the rank's
    device, `cuda` unless the caller built it on the CPU."""
    return DataParallelPPO(task, num_envs, mesh, cfg)
