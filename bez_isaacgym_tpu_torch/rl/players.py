"""Policy players: checkpoint inference.

Port of `bez_isaacgym_tpu/rl/players.py`.  `PpoPlayerContinuous` builds the
actor-critic, `restore()`s a checkpoint the JAX package wrote (weights and
running mean/std, read by `utils.checkpoint.read_msgpack`), answers
`get_action(obs, deterministic)` with env-scaled actions (mu when
deterministic) and runs a batched eval loop with episode accounting.
`PpoPlayerDiscrete` and `SACPlayer` follow their JAX counterparts and
restore their own checkpoint layouts.  Sampling draws from an explicit
`torch.Generator` where the JAX players take a key.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from bez_isaacgym_tpu_torch import convert, resolve_device
from bez_isaacgym_tpu_torch.rl.networks import (ACTION_LIMIT, RunningMeanStd,
                                                init_flax_like)
from bez_isaacgym_tpu_torch.rl.ppo import PPOConfig, build_net
from bez_isaacgym_tpu_torch.tasks.base import BezTask
from bez_isaacgym_tpu_torch.utils.checkpoint import read_msgpack

Tensor = torch.Tensor
F32 = torch.float32

# The JAX package's PPO TrainState (rl/ppo.py), as flax writes it: a
# NamedTuple becomes a dict of its fields.
TRAIN_STATE_FIELDS = ("params", "opt_state", "obs_rms", "value_rms", "lr",
                      "epoch", "key")


def _read_layout(path: str, fields) -> dict:
    """The checkpoint's state dict; raises unless its top-level fields are
    exactly `fields`, as flax's restore into the JAX player's template
    does."""
    state = read_msgpack(path)
    if not isinstance(state, dict) or set(state) != set(fields):
        got = sorted(state) if isinstance(state, dict) else type(state)
        raise ValueError(f"{path}: the checkpoint's fields {got} do not "
                         f"match the player's layout {sorted(fields)}")
    return state


def _generator(gen, device) -> torch.Generator:
    """The caller's generator, or one seeded 0 (the JAX players' default
    key is PRNGKey(0))."""
    return gen if gen is not None else \
        torch.Generator(device=device).manual_seed(0)


class PpoPlayerContinuous:
    """The network `cfg` trains (units, the central-value option), with
    observations normalized when `cfg.normalize_input`.  Recurrent
    checkpoints (`cfg.rnn_units > 0`) are played by `rl.runner.Runner`."""

    def __init__(self, task: BezTask, cfg: PPOConfig = PPOConfig(),
                 checkpoint_path: str = "", device="cuda", seed: int = 0):
        if cfg.rnn_units > 0:
            raise ValueError("PpoPlayerContinuous plays feed-forward "
                             "policies; play an LSTM checkpoint with "
                             "rl.runner.Runner (test=True)")
        self.task = task
        self.cfg = cfg
        self.device = resolve_device(device)
        self.net = build_net(task.num_obs, task.num_actions, cfg)
        init_flax_like(self.net, torch.Generator().manual_seed(seed))
        self.net.to(self.device)
        self.obs_rms = RunningMeanStd.create((task.num_obs,), self.device)
        self.value_rms = RunningMeanStd.create((), self.device)
        if checkpoint_path:
            self.restore(checkpoint_path)

    def restore(self, path: str) -> None:
        """Load model weights and running normalization from a PPO
        TrainState checkpoint; any other layout raises."""
        state = _read_layout(path, TRAIN_STATE_FIELDS)
        self.net.load_state_dict(convert.network(state["params"]))
        self.obs_rms = convert.running_mean_std(state["obs_rms"], self.device)
        self.value_rms = convert.running_mean_std(state["value_rms"],
                                                  self.device)

    @torch.no_grad()
    def get_action(self, obs, deterministic: bool = True,
                   gen: torch.Generator | None = None) -> Tensor:
        """clip(mu, -1, 1), or clip(mu + exp(log_std) z, -1, 1) when
        sampling (rl/ppo.py:157-164)."""
        obs = torch.as_tensor(obs, dtype=F32, device=self.device)
        x = self.obs_rms.normalize(obs) if self.cfg.normalize_input else obs
        mu, log_std, _ = self.net(x)
        a = mu
        if not deterministic:
            z = torch.randn(mu.shape, generator=_generator(gen, self.device),
                            device=self.device)
            a = mu + torch.exp(log_std) * z
        return ACTION_LIMIT * a.clamp(-1.0, 1.0)

    def run(self, env, num_steps: int = 600, deterministic: bool = True,
            gen: torch.Generator | None = None) -> dict:
        """Batched eval loop with per-episode reward/length accounting."""
        gen = _generator(gen, self.device)
        obs = env.reset()
        returns = np.zeros(env.num_envs)
        lengths = np.zeros(env.num_envs, dtype=int)
        done_returns, done_lengths = [], []
        for _ in range(num_steps):
            actions = self.get_action(obs, deterministic, gen)
            obs, reward, done, _ = env.step(actions)
            returns += reward.cpu().numpy()
            lengths += 1
            d = done.cpu().numpy()
            if d.any():
                done_returns.extend(returns[d].tolist())
                done_lengths.extend(lengths[d].tolist())
                returns[d] = 0.0
                lengths[d] = 0
        games = max(1, len(done_returns))
        return {
            "episodes": len(done_returns),
            "mean_reward": float(np.sum(done_returns)) / games,
            "mean_length": float(np.sum(done_lengths)) / games,
        }


class _DiscreteNet(nn.Module):
    """ELU MLP with one logits head per action dimension."""

    def __init__(self, num_obs: int, units: Sequence[int], dims: list[int]):
        super().__init__()
        sizes = [num_obs, *units]
        self.hidden = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(sizes, sizes[1:]))
        self.heads = nn.ModuleList(nn.Linear(units[-1], d) for d in dims)

    def forward(self, x: Tensor) -> list[Tensor]:
        for lin in self.hidden:
            x = F.elu(lin(x))
        return [h(x) for h in self.heads]


class PpoPlayerDiscrete:
    """Discrete / multi-discrete policy player: categorical logits, argmax
    (deterministic) or sampled actions, optional action masks, restore of
    weights and running normalization ({"params", "obs_rms"})."""

    def __init__(self, num_obs: int, actions_num, units=(256, 128),
                 normalize_input: bool = True, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.multi = isinstance(actions_num, (tuple, list))
        self.actions_num = actions_num
        self.normalize_input = normalize_input
        dims = list(actions_num) if self.multi else [actions_num]
        self.net = _DiscreteNet(num_obs, units, dims)
        init_flax_like(self.net, torch.Generator().manual_seed(seed))
        self.net.to(self.device)
        self.obs_rms = RunningMeanStd.create((num_obs,), self.device)

    @torch.no_grad()
    def _act(self, obs, deterministic: bool, masks, gen):
        x = torch.as_tensor(obs, dtype=F32, device=self.device)
        if self.normalize_input:
            x = self.obs_rms.normalize(x)
        outs = []
        for i, lg in enumerate(self.net(x)):
            if masks is not None:
                lg = torch.where(masks[i], lg, torch.full_like(lg, -1e9))
            if deterministic:
                outs.append(torch.argmax(lg, dim=-1))
            else:
                p = torch.softmax(lg, dim=-1).reshape(-1, lg.shape[-1])
                outs.append(torch.multinomial(
                    p, 1, generator=_generator(gen, self.device))
                    .reshape(lg.shape[:-1]))
        a = torch.stack(outs, dim=-1)
        return a if self.multi else a[..., 0]

    def get_action(self, obs, deterministic: bool = True, gen=None):
        return self._act(obs, deterministic, None, gen)

    def get_masked_action(self, obs, action_masks, deterministic: bool = True,
                          gen=None):
        def mask(m):
            return torch.as_tensor(m, dtype=torch.bool, device=self.device)

        masks = [mask(m) for m in action_masks] if self.multi \
            else [mask(action_masks)]
        return self._act(obs, deterministic, masks, gen)

    def restore(self, path: str) -> None:
        state = _read_layout(path, ("params", "obs_rms"))
        names = ([f"hidden.{i}" for i in range(len(self.net.hidden))]
                 + [f"heads.{i}" for i in range(len(self.net.heads))])
        self.net.load_state_dict(convert.mlp(state["params"], names))
        self.obs_rms = convert.running_mean_std(state["obs_rms"], self.device)


class _SACActor(nn.Module):
    def __init__(self, num_obs: int, num_actions: int, units):
        super().__init__()
        sizes = [num_obs, *units]
        self.hidden = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(sizes, sizes[1:]))
        self.mu = nn.Linear(units[-1], num_actions)
        self.log_std = nn.Linear(units[-1], num_actions)

    def forward(self, x: Tensor):
        for lin in self.hidden:
            x = F.relu(lin(x))
        return self.mu(x), self.log_std(x).clamp(-5.0, 2.0)


class _SACCritic(nn.Module):
    def __init__(self, num_obs: int, num_actions: int, units):
        super().__init__()
        sizes = [num_obs + num_actions, *units]
        self.hidden = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(sizes, sizes[1:]))
        self.value = nn.Linear(units[-1], 1)

    def forward(self, x: Tensor, a: Tensor) -> Tensor:
        x = torch.cat([x, a], dim=-1)
        for lin in self.hidden:
            x = F.relu(lin(x))
        return self.value(x)[..., 0]


class SACPlayer:
    """SAC policy player: tanh-Gaussian actor, the mean action unless
    sampling, actions clamped to the action range; restore() loads
    {"actor", "critic", "critic_target"}."""

    def __init__(self, task: BezTask, units=(256, 256), seed: int = 0,
                 checkpoint_path: str = "", device="cuda"):
        self.task = task
        self.device = resolve_device(device)
        self.action_range = (-1.0, 1.0)
        na, no = task.num_actions, task.num_obs
        gen = torch.Generator().manual_seed(seed)
        self.actor = _SACActor(no, na, units)
        self.critic = _SACCritic(no, na, units)
        init_flax_like(self.actor, gen)
        init_flax_like(self.critic, gen)
        self.critic_target = _SACCritic(no, na, units)
        self.critic_target.load_state_dict(self.critic.state_dict())
        for m in (self.actor, self.critic, self.critic_target):
            m.to(self.device)
        if checkpoint_path:
            self.restore(checkpoint_path)

    @torch.no_grad()
    def get_action(self, obs, sample: bool = False, gen=None) -> Tensor:
        obs = torch.as_tensor(obs, dtype=F32, device=self.device)
        mu, log_std = self.actor(obs)
        a = mu
        if sample:
            z = torch.randn(mu.shape, generator=_generator(gen, self.device),
                            device=self.device)
            a = mu + torch.exp(log_std) * z
        return torch.tanh(a).clamp(*self.action_range)

    def restore(self, path: str) -> None:
        state = _read_layout(path, ("actor", "critic", "critic_target"))
        n = len(self.actor.hidden)
        hidden = [f"hidden.{i}" for i in range(n)]
        self.actor.load_state_dict(convert.mlp(state["actor"],
                                               hidden + ["mu", "log_std"]))
        for name in ("critic", "critic_target"):
            getattr(self, name).load_state_dict(
                convert.mlp(state[name], hidden + ["value"]))
