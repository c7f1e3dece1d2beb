"""VecEnv: batched environment wrapper over a task.

Port of `bez_isaacgym_tpu/envs/vec_env.py`: `step(actions) -> (obs, reward,
done, info)` over `num_envs` environments with auto-reset, on the task's
device (the CUDA substep kernel there).  Randomness comes from one
`torch.Generator` seeded with `seed`.

`sharding` (`parallel/mesh.py::env_sharding(mesh)`, the JAX `sharding`
argument): every rank resets all `num_envs` envs from its generator (the
same seed gives every rank the same states) and keeps its shard, which it
then steps: observations, rewards and actions are the shard's rows.
"""

from __future__ import annotations

import numpy as np
import torch

from bez_isaacgym_tpu_torch.tasks.base import BezTask, StepOutput
from bez_isaacgym_tpu_torch.utils.spaces import Box


class VecEnv:

    def __init__(self, task: BezTask, num_envs: int, seed: int = 0,
                 sharding=None):
        self.task = task
        self.num_envs = num_envs
        self.sharding = sharding
        self.num_obs = task.num_obs
        self.num_actions = task.num_actions
        self.device = task.device

        self.observation_space = Box.symmetric(np.inf, task.num_obs)
        # Box(-1, 1) like the reference act_space (vec_task.py:95); the
        # env-side clip_actions clamp is applied inside the task step.
        self.action_space = Box.symmetric(1.0, task.num_actions)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = None

    def reset(self) -> torch.Tensor:
        """Fresh episode for every env; returns the obs of one zero-action
        step (vec_task.py:361-377), whose state the next step() continues
        from."""
        self.state = self.task.reset(self.gen, self.num_envs)
        if self.sharding is not None:
            self.state = self.sharding(self.state)
        zeros = torch.zeros((self.state.progress.shape[0], self.num_actions),
                            dtype=torch.float32, device=self.device)
        out: StepOutput = self.task.step_batch(self.state, zeros, self.gen)
        self.state = out.state
        return out.obs

    def step(self, actions):
        """-> (obs, reward, done, info) with info['time_outs']
        (vec_task.py:331-341)."""
        if self.state is None:
            self.reset()
        actions = torch.as_tensor(actions, dtype=torch.float32,
                                  device=self.device)
        out: StepOutput = self.task.step_batch(self.state, actions, self.gen)
        self.state = out.state
        return out.obs, out.reward, out.done, {"time_outs": out.time_out}
