"""Rank-side jobs of the port's data-parallel CPU tests
(`tests/test_torch_parallel.py`, `tests/test_torch_mpc_parallel.py`).

Not a test file: `parallel/distributed.py::spawn_ranks(run_jobs, 2, jobs)`
runs `run_jobs` in each spawned rank, which joins a gloo group on the CPU
and runs every (name, kwargs) job of `jobs` on its shard.  Imports torch
and the port only (no JAX: the ranks start in seconds).
"""

from __future__ import annotations

from unittest import mock

import numpy as np
import torch

from bez_isaacgym_tpu_torch.parallel import distributed
from bez_isaacgym_tpu_torch.parallel.dp import data_parallel_ppo
from bez_isaacgym_tpu_torch.parallel.mesh import env_mesh, env_sharding
from bez_isaacgym_tpu_torch.rl import ppo as tppo
from bez_isaacgym_tpu_torch.rl.networks import RunningMeanStd
from bez_isaacgym_tpu_torch.tasks.base import TaskConfig, tree_map
from bez_isaacgym_tpu_torch.tasks.kick import KickTask


def _rms(mesh, batch, returns):
    """RunningMeanStd.update of this rank's rows of a vector batch and of
    a scalar batch, the moments summed over the group."""
    shard = env_sharding(mesh)
    vec = RunningMeanStd.create(batch.shape[1:]).update(
        shard(torch.as_tensor(batch)), mesh.group)
    sca = RunningMeanStd.create(()).update(shard(torch.as_tensor(returns)),
                                           mesh.group)
    return {"vec": tuple(vec), "scalar": tuple(sca)}


def _adv(mesh, adv, returns):
    """PPO._normalized on this rank's rows: value_rms updated on the
    returns, advantages normalized by the group's mean and std."""
    shard = env_sharding(mesh)
    task = KickTask(TaskConfig(substeps=1), device="cpu")
    n = adv.shape[0] // mesh.world
    ppo = tppo.PPO(task, n, tppo.PPOConfig(units=(16, 16)), mesh.group)
    ts = ppo.init(torch.Generator().manual_seed(0))
    ts, adv_n, ret_n = ppo._normalized(ts, shard(torch.as_tensor(adv)),
                                       shard(torch.as_tensor(returns)))
    return {"adv": adv_n, "returns": ret_n, "value_rms": tuple(ts.value_rms)}


def _ppo(mesh, cfg, num_envs, ts, env_state, obs, first, noise, perms,
         carry=None):
    """One data_parallel_ppo iteration on this rank's shard from the given
    TrainState and global start states, with this rank's draws (noise and
    perms indexed by rank); every auto-reset takes `first` (env 0's
    start state).  Returns the new state, the metrics, this rank's
    trajectory, last obs and (recurrent) LSTM carry after the rollout, each
    minibatch's KL, and each step's gradients (averaged over the
    ranks)."""
    task = KickTask(TaskConfig(substeps=1), device="cpu")
    dp = data_parallel_ppo(task, num_envs, mesh, tppo.PPOConfig(**cfg))
    shard = env_sharding(mesh)
    kls, grads, kept = [], [], {}
    real_adapt, real_rollout = tppo.adapt_lr, dp.ppo.rollout
    real_clip = tppo.clip_by_global_norm

    def clip(g, max_norm):
        grads.append(g)
        return real_clip(g, max_norm)

    def adapt(lr, kl, c):
        kls.append(float(kl))
        return real_adapt(lr, kl, c)

    def rollout(*a, **k):
        out = real_rollout(*a, **k)
        kept["traj"], kept["last_obs"] = out[-1], out[1]
        kept["carry"] = out[2] if len(out) == 4 else None
        return out

    def reset(self, gen, n, dr_step=0):
        return tree_map(lambda x: x.expand((n,) + x.shape[1:]).clone(),
                        first)

    dp.ppo.rollout = rollout
    extra = () if carry is None else (shard(carry),)
    with mock.patch.object(tppo, "adapt_lr", adapt), \
            mock.patch.object(tppo, "clip_by_global_norm", clip), \
            mock.patch.object(KickTask, "reset", reset):
        out = dp.train_iter(
            dp.check(ts), shard(env_state), shard(obs), *extra,
            torch.Generator().manual_seed(0), noise=noise[mesh.rank],
            perms=perms[mesh.rank])
    return {"ts": out[0], "metrics": out[-1], "traj": kept["traj"],
            "last_obs": kept["last_obs"], "carry": kept["carry"],
            "kls": kls, "grads": grads}


def _mpc(mesh, num_solves, seed, noise):
    """The data-parallel MPPI solve of this rank's slice of num_solves
    walk envs (reset from `seed` on every rank), with this rank's noise
    (None: its own generator), and the gathered global actions."""
    from bez_isaacgym_tpu_torch.parallel.mesh import rank_generator
    from bez_isaacgym_tpu_torch.parallel.mpc import data_parallel_mpc
    from bez_isaacgym_tpu_torch.solvers.mppi import MPPIConfig, MPPISolver
    from bez_isaacgym_tpu_torch.tasks.walk import WalkTask

    task = WalkTask(TaskConfig(substeps=1, episode_length_s=10.0),
                    device="cpu")
    solver = MPPISolver(task, MPPIConfig(horizon=2, num_samples=2))
    envs = env_sharding(mesh)(task.reset(torch.Generator().manual_seed(seed),
                                         num_solves))
    mpc = data_parallel_mpc(solver, mesh)
    act, st, info = mpc(envs, solver.init_state(num_solves // mesh.world),
                        rank_generator(seed, mesh),
                        noise=None if noise is None else noise[mesh.rank])
    return {"actions": act, "nominal": st.nominal, "global": mpc.gather(act)}


JOBS = {"rms": _rms, "adv": _adv, "ppo": _ppo, "mpc": _mpc}


def run_jobs(rank: int, jobs: list) -> dict:
    """Join the gloo group on the CPU, then run each job; returns
    {name: result} and the init summary."""
    torch.set_num_threads(1)
    np.random.seed(rank)
    out = {"summary": distributed.init_distributed(device="cpu")}
    mesh = env_mesh("cpu")
    for name, job, kw in jobs:
        out[name] = JOBS[job](mesh, **kw)
    return out
