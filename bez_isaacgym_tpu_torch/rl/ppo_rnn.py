"""Recurrent PPO: LSTM policy with truncated BPTT over seq_len windows.

Port of `bez_isaacgym_tpu/rl/ppo_rnn.py` (the reference's commented-out
rnn option, cfg/train/bez_kickPPO.yaml:34-40: lstm 128, 1 layer,
before_mlp, concat_input; seq_len 4 at :78):

- the rollout threads a per-env LSTM carry, zeroed when an episode ends;
- training splits the horizon into seq_len windows, keeps the carry at each
  window start, and replays the cell through the window with the same
  done-zeroing, so minibatches are drawn over sequences, not steps;
- everything else (GAE, clipped losses, adaptive-KL LR, running norms, the
  optimizer, and the data-parallel `group`'s all_reduces) is rl/ppo.py's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import functional_call

from bez_isaacgym_tpu_torch.rl.networks import ACTION_LIMIT, gaussian_logp
from bez_isaacgym_tpu_torch.rl.ppo import (PPO, PPOConfig, TrainState,
                                           episode_metrics, ppo_loss)
from bez_isaacgym_tpu_torch.tasks.base import BezTask, EnvState

Tensor = torch.Tensor
F32 = torch.float32


class TransitionRNN(NamedTuple):
    obs: Tensor
    action: Tensor
    logp: Tensor
    value: Tensor
    reward: Tensor
    done: Tensor
    time_out: Tensor
    mu: Tensor
    log_std: Tensor
    carry_h: Tensor          # LSTM carry entering this step
    carry_c: Tensor
    ep_ret: Tensor           # episode return incl. this step (where done)
    ep_len: Tensor           # episode length (where done)


def zero_done(carry, done: Tensor):
    """The carry with the rows of finished episodes zeroed."""
    d = done[:, None]
    return tuple(torch.where(d, 0.0, c) for c in carry)


class PPORNN(PPO):
    """Recurrent PPO (the JAX `make_ppo_rnn`).

    train_iter(ts, env_state, last_obs, carry, gen) ->
        (ts, env_state, last_obs, carry, metrics)
    act(ts, obs, carry, gen=None, deterministic=True) -> (action, carry)
    """

    def __init__(self, task: BezTask, num_envs: int, cfg: PPOConfig,
                 group=None):
        if cfg.rnn_units <= 0:
            raise ValueError("PPORNN needs cfg.rnn_units > 0")
        if cfg.horizon % cfg.seq_len:
            raise ValueError(f"horizon {cfg.horizon} is not a multiple of "
                             f"seq_len {cfg.seq_len}")
        super().__init__(task, num_envs, cfg, group)

    def initial_carry(self, n: int | None = None):
        z = torch.zeros((n or self.num_envs, self.cfg.rnn_units), dtype=F32,
                        device=self.device)
        return (z, z)

    def _apply(self, params, obs_rms, obs, carry):
        x = obs_rms.normalize(obs) if self.cfg.normalize_input else obs
        return functional_call(self.net, params, (x, carry))

    @torch.no_grad()
    def act(self, ts: TrainState, obs: Tensor, carry, gen=None,
            deterministic: bool = True):
        carry, mu, log_std, _ = self._apply(ts.params, ts.obs_rms, obs, carry)
        a = mu if deterministic else mu + torch.exp(log_std) * torch.randn(
            mu.shape, generator=gen, device=mu.device)
        return ACTION_LIMIT * a.clamp(-1.0, 1.0), carry

    @torch.no_grad()
    def rollout(self, ts: TrainState, env_state: EnvState, last_obs: Tensor,
                carry, gen: torch.Generator, noise: Tensor | None = None):
        """Returns (env_state, last_obs, carry, traj)."""
        obs, steps = last_obs, []
        for t in range(self.cfg.horizon):
            new_carry, mu, log_std, value = self._apply(
                ts.params, ts.obs_rms, obs, carry)
            eps = noise[t] if noise is not None else torch.randn(
                mu.shape, generator=gen, device=mu.device)
            action = mu + torch.exp(log_std) * eps
            out = self.task.step_batch(
                env_state, ACTION_LIMIT * action.clamp(-1.0, 1.0), gen)
            steps.append(TransitionRNN(
                obs=obs, action=action,
                logp=gaussian_logp(mu, log_std, action), value=value,
                reward=out.reward, done=out.done, time_out=out.time_out,
                mu=mu, log_std=log_std, carry_h=carry[1], carry_c=carry[0],
                ep_ret=out.state.ep_reward,
                ep_len=out.state.progress.to(F32)))
            # RNN-state reset on done (play.py:196-199 parity).
            carry = zero_done(new_carry, out.done)
            env_state, obs = out.state, out.obs
        traj = TransitionRNN(*map(torch.stack, zip(*steps)))
        return env_state, obs, carry, traj

    def _last_value(self, ts, last_obs, carry):
        return self._apply(ts.params, ts.obs_rms, last_obs, carry)[3]

    def _to_sequences(self, x: Tensor) -> Tensor:
        """(H, N, ...) -> (N*W, seq_len, ...), W = H // seq_len windows,
        env-major (rl/ppo_rnn.py:153-159)."""
        H, N, L = x.shape[0], x.shape[1], self.cfg.seq_len
        x = x.reshape((H // L, L, N) + x.shape[2:])
        x = torch.movedim(x, 2, 0)                 # (N, W, L, ...)
        return x.reshape((N * (H // L), L) + x.shape[3:])

    def update(self, ts: TrainState, traj: TransitionRNN, adv: Tensor,
               returns: Tensor, gen=None, perms=None):
        """Minibatch SGD over sequences: `perms` (one permutation of
        range(N*W) per mini-epoch) replaces the generator's."""
        cfg = self.cfg
        ts, adv, returns_n = self._normalized(ts, adv, returns)
        seq = TransitionRNN(*map(self._to_sequences, traj))
        cols = (seq.obs, seq.action, seq.logp, seq.value,
                self._to_sequences(adv), self._to_sequences(returns_n),
                seq.mu, seq.log_std, seq.done, seq.carry_c[:, 0],
                seq.carry_h[:, 0])
        obs_rms = ts.obs_rms

        def loss_fn(params, mb):
            (obs, action, old_logp, old_v, mb_adv, mb_ret, old_mu, old_ls,
             done, c0, h0) = mb
            carry, outs = (c0, h0), []
            for t in range(cfg.seq_len):
                carry, mu, log_std, value = self._apply(params, obs_rms,
                                                        obs[:, t], carry)
                carry = zero_done(carry, done[:, t])
                outs.append((mu, log_std, value))
            mu, log_std, value = (torch.stack(x, dim=1) for x in zip(*outs))
            return ppo_loss(cfg, mu, log_std, value, action, old_logp, old_v,
                            mb_adv, mb_ret, old_mu, old_ls)

        return self._sgd(ts, seq.obs.shape[0],
                         max(1, cfg.minibatch_size // cfg.seq_len),
                         lambda idx: tuple(c[idx] for c in cols), loss_fn,
                         gen, perms)

    def train_iter(self, ts: TrainState, env_state: EnvState,
                   last_obs: Tensor, carry, gen: torch.Generator,
                   noise: Tensor | None = None, perms=None):
        env_state, last_obs, carry, traj = self.rollout(
            ts, env_state, last_obs, carry, gen, noise)
        ts = self._update_obs_rms(ts, traj)
        adv, returns = self.compute_gae(ts, traj, last_obs, carry)
        ts, metrics = self.update(ts, traj, adv, returns, gen, perms)
        metrics.update(episode_metrics(traj))
        return ts, env_state, last_obs, carry, metrics
