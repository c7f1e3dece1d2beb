"""PPO: rollout through the task's batched step, GAE, minibatch SGD.

Port of `bez_isaacgym_tpu/rl/ppo.py`, the training spec of the reference's
cfg/train/bez_kickPPO.yaml:45-79: gamma 0.99, GAE tau 0.95, adaptive-KL LR
from 3e-4 (threshold 0.008), e_clip 0.2, horizon 32, minibatch 32768, 5
mini-epochs, critic_coef 2, clipped value loss, grad-norm 1.0, entropy 0,
bounds loss 1e-3, reward scale 0.01, obs/value running normalization,
value bootstrap on timeouts.

`PPO(task, num_envs, cfg)` holds the parts of the JAX `make_ppo`: `init`,
`train_iter` and `act`, and the rollout, GAE and update as methods of their
own.  One `train_iter` = one PPO epoch.  The rollout runs under
`torch.no_grad()` through `task.step_batch` (the CUDA substep kernel on a
card); the update differentiates only the network, on stored tensors.
Parameters are a dict of tensors applied with `torch.func.functional_call`,
and the optimizer is written out: optax's `clip_by_global_norm` then
`scale_by_adam` (b1 0.9, b2 0.999, eps 1e-8), scaled by the adaptive
learning rate.  Draws come from an explicit `torch.Generator`; the
rollout's Gaussian noise and each mini-epoch's permutation can instead be
passed in (parity tests feed the JAX package's draws).

With a process `group` (data-parallel training, `parallel/dp.py`) every
rank runs this on its shard of the envs, and the JAX package's `axis_name`
collectives become all_reduces over the group: the running stats' batch
moments, the advantages' mean and std, and each minibatch's gradients and
KL, averaged in one all_reduce of a flat buffer.  With `group=None` nothing
is reduced.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from portbench.reference.rl.networks import (ACTION_LIMIT, ActorCritic,
                                                ActorCriticLSTM,
                                                CentralValue, RunningMeanStd,
                                                WithCentralValue,
                                                gaussian_kl, gaussian_logp,
                                                init_flax_like)
from portbench.reference.tasks.base import BezTask, EnvState

Tensor = torch.Tensor
F32 = torch.float32
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclass(frozen=True)
class PPOConfig:
    gamma: float = 0.99
    tau: float = 0.95
    learning_rate: float = 3e-4
    lr_max: float = 1e-2        # adaptive-KL LR ceiling.  Lower it (e.g.
                                # 2e-5) when fine-tuning a restored
                                # checkpoint: on resume the KL starts tiny,
                                # the adaptive rule balloons the LR to the
                                # ceiling, and a converged policy can be
                                # destroyed before KL pressure reins it in.
    kl_threshold: float = 0.008
    e_clip: float = 0.2
    horizon: int = 32
    minibatch_size: int = 32768
    mini_epochs: int = 5
    critic_coef: float = 2.0
    grad_norm: float = 1.0
    entropy_coef: float = 0.0
    bounds_loss_coef: float = 0.001
    reward_scale: float = 0.01       # reward_shaper scale_value
    normalize_input: bool = True
    normalize_value: bool = True
    # rnn_units > 0 selects the LSTM actor-critic (rl/ppo_rnn.py) trained
    # with truncated BPTT over seq_len windows (bez_kickPPO.yaml:34-40, 78).
    rnn_units: int = 0
    seq_len: int = 4
    normalize_advantage: bool = True
    value_bootstrap: bool = True
    clip_value: bool = True
    units: tuple = (400, 200, 100)
    # Central-value option (torch_runner.py:78-84): a separate critic MLP
    # on the same observations replaces the shared value head.
    central_value: bool = False
    central_value_units: tuple = (400, 200, 100)


class AdamState(NamedTuple):
    """optax's ScaleByAdamState: the step count and the moments, keyed by
    parameter name."""

    count: Tensor           # int32 ()
    mu: dict
    nu: dict


class TrainState(NamedTuple):
    params: dict            # parameter name -> tensor (the net's names)
    opt_state: AdamState
    obs_rms: RunningMeanStd
    value_rms: RunningMeanStd
    lr: Tensor              # f32 (), the adaptive-KL learning rate
    epoch: Tensor           # int32 ()
    key: np.ndarray         # uint32[2]: the JAX package's PRNG key, carried
                            # for the checkpoint layout; the port draws from
                            # a torch.Generator


class Transition(NamedTuple):
    obs: Tensor
    action: Tensor
    logp: Tensor
    value: Tensor
    reward: Tensor
    done: Tensor
    time_out: Tensor
    mu: Tensor
    log_std: Tensor
    ep_ret: Tensor          # cumulative unscaled episode reward incl. this
                            # step (valid as episode return where done)
    ep_len: Tensor          # steps since episode start (valid where done)


def build_net(num_obs: int, num_actions: int, cfg: PPOConfig) -> nn.Module:
    """The network `cfg` trains, with the port's parameter names."""
    if cfg.rnn_units > 0:
        return ActorCriticLSTM(num_obs, num_actions, cfg.units, cfg.rnn_units)
    ac = ActorCritic(num_obs, num_actions, cfg.units)
    if cfg.central_value:
        return WithCentralValue(ac, CentralValue(num_obs,
                                                 cfg.central_value_units))
    return ac


def clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    """optax.clip_by_global_norm: g * max_norm / |g| only where |g| >=
    max_norm (no epsilon, unlike `torch.nn.utils.clip_grad_norm_`)."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    keep = g_norm < max_norm
    return {k: torch.where(keep, g, (g / g_norm) * max_norm)
            for k, g in grads.items()}


def adam_update(grads: dict, state: AdamState):
    """optax.scale_by_adam (eps_root 0): the update direction and the new
    state."""
    mu = {k: (1 - ADAM_B1) * g + ADAM_B1 * state.mu[k]
          for k, g in grads.items()}
    nu = {k: (1 - ADAM_B2) * (g * g) + ADAM_B2 * state.nu[k]
          for k, g in grads.items()}
    count = state.count + 1
    c = count.to(F32)
    bc1 = 1 - torch.tensor(ADAM_B1, dtype=F32, device=c.device) ** c
    bc2 = 1 - torch.tensor(ADAM_B2, dtype=F32, device=c.device) ** c
    u = {k: (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)
         for k in grads}
    return u, AdamState(count=count, mu=mu, nu=nu)


def adapt_lr(lr: Tensor, kl: Tensor, cfg: PPOConfig) -> Tensor:
    """rl-games AdaptiveScheduler on this minibatch's KL, clipped to
    [1e-6, lr_max] (rl/ppo.py:280-282)."""
    lr = torch.where(kl > 2.0 * cfg.kl_threshold, lr / 1.5, lr)
    lr = torch.where(kl < 0.5 * cfg.kl_threshold, lr * 1.5, lr)
    return lr.clamp(1e-6, cfg.lr_max)


def ppo_loss(cfg: PPOConfig, mu, log_std, value, action, old_logp, old_v,
             adv, ret, old_mu, old_log_std):
    """Clipped surrogate + (clipped) value loss + bounds loss; returns
    (total, (a_loss, c_loss, entropy, kl))."""
    logp = gaussian_logp(mu, log_std, action)
    ratio = torch.exp(logp - old_logp)
    surr1 = adv * ratio
    surr2 = adv * ratio.clamp(1.0 - cfg.e_clip, 1.0 + cfg.e_clip)
    a_loss = -torch.minimum(surr1, surr2).mean()
    if cfg.clip_value:
        v_clipped = old_v + (value - old_v).clamp(-cfg.e_clip, cfg.e_clip)
        c_loss = torch.maximum((value - ret) ** 2,
                               (v_clipped - ret) ** 2).mean()
    else:
        c_loss = ((value - ret) ** 2).mean()
    entropy = torch.sum(log_std + 0.5 * math.log(2.0 * math.pi * math.e),
                        dim=-1).mean()
    b_loss = torch.sum((mu - 1.1).clamp_min(0.0) ** 2
                       + (-mu - 1.1).clamp_min(0.0) ** 2, dim=-1).mean()
    total = (a_loss + 0.5 * cfg.critic_coef * c_loss
             - cfg.entropy_coef * entropy + cfg.bounds_loss_coef * b_loss)
    kl = gaussian_kl(old_mu, old_log_std, mu, log_std).mean()
    return total, (a_loss, c_loss, entropy, kl)


def episode_metrics(traj) -> dict:
    """Per-iteration means of the rollout and of the episodes that
    completed in it (RLGPUAlgoObserver, rlgames_utils.py:130-154)."""
    done_f = traj.done.to(F32)
    n_done = done_f.sum()
    zero = torch.zeros((), dtype=F32, device=n_done.device)
    return {
        "reward_mean": traj.reward.mean(),
        "done_frac": done_f.mean(),
        "value_mean": traj.value.mean(),
        "ep_reward_mean": torch.where(
            n_done > 0, (traj.ep_ret * done_f).sum() / n_done.clamp_min(1),
            zero),
        "ep_len_mean": torch.where(
            n_done > 0, (traj.ep_len * done_f).sum() / n_done.clamp_min(1),
            zero),
        "ep_count": n_done,
    }


def pmean_flat(tensors: list, group) -> list:
    """The JAX `pmean` of each tensor over the group's ranks, in one
    all_reduce of a flat f32 buffer (gloo pays per call)."""
    flat = torch.cat([t.reshape(-1).to(F32) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat = flat / dist.get_world_size(group)
    return [x.reshape(t.shape) for x, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


class PPO:
    """PPO on `task` with `num_envs` envs (the JAX `make_ppo`); `group`
    is the data-parallel process group (the JAX `axis_name`)."""

    def __init__(self, task: BezTask, num_envs: int,
                 cfg: PPOConfig = PPOConfig(), group=None):
        self.task = task
        self.num_envs = num_envs
        self.cfg = cfg
        self.group = group
        self.device = task.device
        # The architecture; its own parameters are never read (TrainState
        # holds them).
        self.net = build_net(task.num_obs, task.num_actions, cfg).to(
            self.device)

    # ------------------------------------------------------------ state
    def init(self, gen: torch.Generator) -> TrainState:
        """A fresh TrainState: flax-like initial weights drawn from `gen`
        (on the run's device), zero Adam moments, unit running stats."""
        net = build_net(self.task.num_obs, self.task.num_actions,
                        self.cfg).to(self.device)
        init_flax_like(net, gen)
        params = {k: v.detach() for k, v in net.named_parameters()}
        dev = self.device
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        return TrainState(
            params=params,
            opt_state=AdamState(
                count=torch.zeros((), dtype=torch.int32, device=dev),
                mu=zeros, nu=dict(zeros)),
            obs_rms=RunningMeanStd.create((self.task.num_obs,), dev),
            value_rms=RunningMeanStd.create((), dev),
            lr=torch.tensor(self.cfg.learning_rate, dtype=F32, device=dev),
            epoch=torch.zeros((), dtype=torch.int32, device=dev),
            key=np.zeros(2, np.uint32))

    def check(self, ts: TrainState) -> TrainState:
        """`ts` (a restored state) on this run's device; raises unless its
        parameters are exactly this network's, names and shapes."""
        want = {k: tuple(v.shape) for k, v in self.net.named_parameters()}
        got = {k: tuple(v.shape) for k, v in ts.params.items()}
        if got != want:
            raise ValueError(f"the checkpoint's parameters {got} do not "
                             f"match the network's {want}")
        return _to(ts, self.device)

    # ------------------------------------------------------------ policy
    def _apply(self, params: dict, obs_rms: RunningMeanStd, obs: Tensor):
        x = obs_rms.normalize(obs) if self.cfg.normalize_input else obs
        return functional_call(self.net, params, (x,))

    @torch.no_grad()
    def act(self, ts: TrainState, obs: Tensor, gen=None,
            deterministic: bool = True) -> Tensor:
        """Policy action for play/eval (mu when deterministic; env action
        = limit * clip(a, -1, 1))."""
        mu, log_std, _ = self._apply(ts.params, ts.obs_rms, obs)
        a = mu if deterministic else mu + torch.exp(log_std) * torch.randn(
            mu.shape, generator=gen, device=mu.device)
        return ACTION_LIMIT * a.clamp(-1.0, 1.0)

    # ------------------------------------------------------------ rollout
    @torch.no_grad()
    def rollout(self, ts: TrainState, env_state: EnvState, last_obs: Tensor,
                gen: torch.Generator, noise: Tensor | None = None):
        """cfg.horizon env steps from all envs; `noise` (H, N, A) replaces
        the Gaussian draws.  Returns (env_state, last_obs, traj) with traj
        fields (H, N, ...)."""
        obs, steps = last_obs, []
        for t in range(self.cfg.horizon):
            mu, log_std, value = self._apply(ts.params, ts.obs_rms, obs)
            eps = noise[t] if noise is not None else torch.randn(
                mu.shape, generator=gen, device=mu.device)
            action = mu + torch.exp(log_std) * eps
            out = self.task.step_batch(
                env_state, ACTION_LIMIT * action.clamp(-1.0, 1.0), gen)
            steps.append(Transition(
                obs=obs, action=action,
                logp=gaussian_logp(mu, log_std, action), value=value,
                reward=out.reward, done=out.done, time_out=out.time_out,
                mu=mu, log_std=log_std, ep_ret=out.state.ep_reward,
                ep_len=out.state.progress.to(F32)))
            env_state, obs = out.state, out.obs
        return env_state, obs, Transition(*map(torch.stack, zip(*steps)))

    def _last_value(self, ts: TrainState, last_obs: Tensor, *_) -> Tensor:
        return self._apply(ts.params, ts.obs_rms, last_obs)[2]

    @torch.no_grad()
    def compute_gae(self, ts: TrainState, traj, last_obs: Tensor, *carry):
        """Advantages and returns (H, N), in the denormalized value space;
        `ts.obs_rms` is the one updated on this rollout."""
        cfg = self.cfg
        last_value = self._last_value(ts, last_obs, *carry)
        values = traj.value
        if cfg.normalize_value:
            values = ts.value_rms.denormalize(values)
            last_value = ts.value_rms.denormalize(last_value)
        done_f = traj.done.to(F32)
        rewards = traj.reward * cfg.reward_scale
        if cfg.value_bootstrap:
            # rl-games value_bootstrap: add gamma*V on timeout resets.
            rewards = rewards + cfg.gamma * values * \
                traj.time_out.to(F32) * done_f
        not_done = 1.0 - done_f
        next_values = torch.cat([values[1:], last_value[None]], dim=0)
        gae = torch.zeros_like(last_value)
        adv = []
        for t in reversed(range(values.shape[0])):
            delta = rewards[t] + cfg.gamma * next_values[t] * not_done[t] \
                - values[t]
            gae = delta + cfg.gamma * cfg.tau * not_done[t] * gae
            adv.append(gae)
        adv = torch.stack(adv[::-1])
        return adv, adv + values

    # ------------------------------------------------------------ update
    def _normalized(self, ts: TrainState, adv: Tensor, returns: Tensor):
        """value_rms updated on the returns before they are normalized
        (rl/ppo.py:226-229); advantages normalized over the batch."""
        cfg = self.cfg
        returns_n = returns
        if cfg.normalize_value:
            ts = ts._replace(value_rms=ts.value_rms.update(returns,
                                                           self.group))
            returns_n = ts.value_rms.normalize(returns)
        if cfg.normalize_advantage:
            mean = self._pmean(adv.mean())
            std = torch.sqrt(self._pmean(((adv - mean) ** 2).mean()))
            adv = (adv - mean) / (std + 1e-8)
        return ts, adv, returns_n

    def _pmean(self, x: Tensor) -> Tensor:
        return x if self.group is None else pmean_flat([x], self.group)[0]

    def _sgd(self, ts: TrainState, n_items: int, mb_items: int, take,
             loss_fn, gen, perms):
        """cfg.mini_epochs passes over n_items in minibatches of mb_items
        (the remainder of each permutation dropped); take(idx) gathers a
        minibatch, loss_fn(params, mb) -> (total, (a, c, entropy, kl))."""
        cfg = self.cfg
        num_mb = max(1, n_items // mb_items)
        params, opt_state, lr = ts.params, ts.opt_state, ts.lr
        rows = []
        for e in range(cfg.mini_epochs):
            perm = perms[e] if perms is not None else torch.randperm(
                n_items, generator=gen, device=self.device)
            perm = torch.as_tensor(perm, device=self.device)
            for idx in perm[: num_mb * mb_items].reshape(num_mb, -1):
                p = {k: v.detach().requires_grad_(True)
                     for k, v in params.items()}
                with torch.enable_grad():
                    total, aux = loss_fn(p, take(idx))
                    grads = torch.autograd.grad(total, list(p.values()),
                                                allow_unused=True)
                grads = {k: torch.zeros_like(v) if g is None else g
                         for (k, v), g in zip(p.items(), grads)}
                kl = aux[3].detach()
                if self.group is not None:
                    # The gradients' and the KL's pmean (the KL keeps the
                    # adaptive LR replicated), one all_reduce.
                    *flat, kl = pmean_flat([*grads.values(), kl], self.group)
                    grads = dict(zip(grads, flat))
                lr = adapt_lr(lr, kl, cfg)
                u, opt_state = adam_update(
                    clip_by_global_norm(grads, cfg.grad_norm), opt_state)
                params = {k: params[k] + (-lr * u[k]) for k in params}
                rows.append(torch.stack([total.detach(),
                                         *[a.detach() for a in aux[:3]],
                                         kl]))
        m = torch.stack(rows).mean(dim=0)
        ts = ts._replace(params=params, opt_state=opt_state, lr=lr,
                         epoch=ts.epoch + 1)
        return ts, {"loss": m[0], "a_loss": m[1], "c_loss": m[2],
                    "entropy": m[3], "kl": m[4], "lr": lr}

    def update(self, ts: TrainState, batch: Transition, adv: Tensor,
               returns: Tensor, gen=None, perms=None):
        """cfg.mini_epochs passes of minibatch SGD over the flat batch
        (fields (n, ...)) with the adaptive-KL LR; `perms` (one permutation
        of range(n) per mini-epoch) replaces the generator's."""
        cfg = self.cfg
        ts, adv, returns_n = self._normalized(ts, adv, returns)
        # batch.value is already in the network's (normalized) output space.
        cols = (batch.obs, batch.action, batch.logp, batch.value, adv,
                returns_n, batch.mu, batch.log_std)
        obs_rms = ts.obs_rms

        def loss_fn(params, mb):
            obs, action, old_logp, old_v, mb_adv, mb_ret, old_mu, old_ls = mb
            mu, log_std, value = self._apply(params, obs_rms, obs)
            return ppo_loss(cfg, mu, log_std, value, action, old_logp, old_v,
                            mb_adv, mb_ret, old_mu, old_ls)

        return self._sgd(ts, adv.shape[0], cfg.minibatch_size,
                         lambda idx: tuple(c[idx] for c in cols), loss_fn,
                         gen, perms)

    def _update_obs_rms(self, ts: TrainState, traj) -> TrainState:
        if not self.cfg.normalize_input:
            return ts
        return ts._replace(obs_rms=ts.obs_rms.update(
            traj.obs.reshape(-1, self.task.num_obs), self.group))

    def train_iter(self, ts: TrainState, env_state: EnvState,
                   last_obs: Tensor, gen: torch.Generator,
                   noise: Tensor | None = None, perms=None):
        """One PPO epoch: rollout, obs_rms update, GAE (with the updated
        obs_rms), minibatch updates.  Returns (ts, env_state, last_obs,
        metrics) with 0-d tensor metrics."""
        env_state, last_obs, traj = self.rollout(ts, env_state, last_obs,
                                                 gen, noise)
        ts = self._update_obs_rms(ts, traj)
        adv, returns = self.compute_gae(ts, traj, last_obs)
        flat = Transition(*[x.reshape((-1,) + x.shape[2:]) for x in traj])
        ts, metrics = self.update(ts, flat, adv.reshape(-1),
                                  returns.reshape(-1), gen, perms)
        metrics.update(episode_metrics(traj))
        return ts, env_state, last_obs, metrics


def _to(ts: TrainState, device) -> TrainState:
    def mv(d):
        return {k: v.to(device) for k, v in d.items()}

    return ts._replace(
        params=mv(ts.params),
        opt_state=AdamState(ts.opt_state.count.to(device),
                            mv(ts.opt_state.mu), mv(ts.opt_state.nu)),
        obs_rms=RunningMeanStd(*[x.to(device) for x in ts.obs_rms]),
        value_rms=RunningMeanStd(*[x.to(device) for x in ts.value_rms]),
        lr=ts.lr.to(device), epoch=ts.epoch.to(device))
