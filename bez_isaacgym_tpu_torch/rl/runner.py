"""Training runner: wires config -> task -> PPO -> checkpoints/metrics.

Port of `bez_isaacgym_tpu/rl/runner.py` (reference: train.py:60-113,
utils/torch_runner.py): build the task on the run's device, init or restore
the train state, loop `train_iter` with periodic checkpoints
(save_frequency / save_best_after, bez_kickPPO.yaml:65-66) in the JAX
package's format and metric logging with its keys; `play` runs a
checkpoint (MLP or LSTM) deterministically, and renders env 0 (`render`:
a live viewer, or an episode file).  The env steps run through the CUDA
substep kernel on a card.

Under `torchrun` (WORLD_SIZE > 1) with `multi_chip=True` each rank trains
its shard of the envs through `parallel/dp.py::data_parallel_ppo`; rank 0
alone prints, writes metrics.jsonl and saves checkpoints.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from bez_isaacgym_tpu_torch import convert
from bez_isaacgym_tpu_torch.parallel.distributed import (init_distributed,
                                                         under_torchrun)
from bez_isaacgym_tpu_torch.parallel.dp import data_parallel_ppo
from bez_isaacgym_tpu_torch.parallel.mesh import (env_mesh, env_sharding,
                                                  rank_generator)
from bez_isaacgym_tpu_torch.rl.ppo import PPO
from bez_isaacgym_tpu_torch.rl.ppo_rnn import PPORNN, zero_done
from bez_isaacgym_tpu_torch.tasks.base import tree_map
from bez_isaacgym_tpu_torch.tasks.registry import make_task
from bez_isaacgym_tpu_torch.utils import checkpoint as ckpt
from bez_isaacgym_tpu_torch.utils.config import RunConfig, pretty, run_device
from bez_isaacgym_tpu_torch.utils.metrics import MetricsLogger
from bez_isaacgym_tpu_torch.utils.seeding import set_seed


class Runner:

    def __init__(self, cfg: RunConfig):
        self.cfg = cfg
        self.device = run_device(cfg)
        self.mesh = None
        if cfg.multi_chip and under_torchrun():
            if cfg.test:
                raise ValueError("play runs in one process: launch it "
                                 "without torchrun, or pass multi_chip=False")
            init_distributed(device=self.device.type)
            self.mesh = env_mesh(self.device.type)
            self.device = self.mesh.device
        self.lead = self.mesh is None or self.mesh.rank == 0
        self.task = make_task(cfg.task, cfg.resolved_task_cfg(),
                              device=self.device)
        self.run_dir = os.path.join(cfg.output_dir, cfg.name)
        self.recurrent = cfg.train.rnn_units > 0
        # The LSTM policy (bez_kickPPO.yaml:34-40 option) or the MLP, on
        # this process's envs or, data-parallel, on this rank's shard.
        if self.mesh is not None:
            self.ppo = data_parallel_ppo(self.task, cfg.num_envs, self.mesh,
                                         cfg.train)
        else:
            self.ppo = (PPORNN if self.recurrent else PPO)(
                self.task, cfg.num_envs, cfg.train)
        self.played: dict = {}

    def _reset(self, gen: torch.Generator):
        """All cfg.num_envs envs reset from `gen` and their first
        observation: it observes the reset states with a zero action
        (progress stays 0, the first rollout sees a real obs)."""
        env_state = self.task.reset(gen, self.cfg.num_envs)
        zero = torch.zeros((self.cfg.num_envs, self.task.num_actions),
                           dtype=torch.float32, device=self.device)
        obs, env_state = self.task.observe(env_state, zero)
        return env_state, obs

    def _init_states(self):
        """(ts, env_state, obs, gen): a fresh or restored TrainState, reset
        envs and their first observation, and the generator the run draws
        from.  Data-parallel, every rank resets all the envs from the same
        run generator and keeps its shard, and then draws from its own
        generator (`parallel/mesh.py::rank_generator`)."""
        cfg = self.cfg
        gen = set_seed(cfg.seed, self.device)
        ts = self.ppo.init(gen)
        env_state, obs = self._reset(gen)
        if cfg.checkpoint:
            ts = self.ppo.check(convert.train_state(
                ckpt.read_msgpack(cfg.checkpoint)))
            self._print(f"restored checkpoint {cfg.checkpoint}")
        if self.mesh is not None:
            shard = env_sharding(self.mesh)
            env_state, obs = shard(env_state), shard(obs)
            gen = rank_generator(cfg.seed, self.mesh)
        return ts, env_state, obs, gen

    def _print(self, *a):
        if self.lead:
            print(*a, flush=True)

    def train(self, max_iterations: int | None = None):
        cfg = self.cfg
        self._print(pretty(cfg))
        logger = MetricsLogger(self.run_dir) if self.lead else None
        ts, env_state, obs, gen = self._init_states()
        frames_per_iter = cfg.num_envs * cfg.train.horizon
        best_reward = -np.inf
        ep_reward_ema = None   # smoothed completed-episode return
        iters = max_iterations or cfg.max_iterations
        carry = self.ppo.initial_carry() if self.recurrent else None
        try:
            for it in range(1, iters + 1):
                if self.recurrent:
                    ts, env_state, obs, carry, metrics = \
                        self.ppo.train_iter(ts, env_state, obs, carry, gen)
                else:
                    ts, env_state, obs, metrics = self.ppo.train_iter(
                        ts, env_state, obs, gen)
                # Episodes complete sparsely within a horizon; the smoothed
                # return is the score the reference logs and ranks
                # checkpoints by (rlgames_utils.py:145-151).
                if float(metrics["ep_count"]) > 0:
                    er = float(metrics["ep_reward_mean"])
                    ep_reward_ema = er if ep_reward_ema is None else \
                        0.9 * ep_reward_ema + 0.1 * er
                score = ep_reward_ema if ep_reward_ema is not None else \
                    float(metrics["reward_mean"])
                if not self.lead:
                    continue
                if it % cfg.log_frequency == 0 or it == 1:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["ep_reward_ema"] = score
                    logger.log(it, it * frames_per_iter, m)
                    print(f"iter {it}: ep_reward {score:.2f} "
                          f"reward/step {m['reward_mean']:.4f} "
                          f"kl {m['kl']:.4f} lr {m['lr']:.2e} "
                          f"done% {100 * m['done_frac']:.1f} "
                          f"ep_len {m['ep_len_mean']:.0f}")
                if it % cfg.save_frequency == 0:
                    ckpt.save(os.path.join(self.run_dir, ckpt.checkpoint_name(
                        cfg.name, it, score)), ts)
                if it > cfg.save_best_after and score > best_reward:
                    best_reward = score
                    # One overwritten best file (the reference re-saves
                    # "<name>_<epoch>.pth" on every new best).
                    ckpt.save(os.path.join(self.run_dir,
                                           f"{cfg.name}_best.ckpt"), ts)
        finally:
            if logger is not None:
                logger.close()
        return ts

    @torch.no_grad()
    def play(self, num_steps: int | None = None,
             deterministic: bool = True) -> float:
        """Checkpoint inference loop (play.py:125-236 parity); returns the
        mean completed-episode reward, and keeps the steps, episodes and
        that mean in `self.played`.

        cfg.render "live" streams env 0 to a `viz.live.LiveViewer` (ESC
        ends the loop, SPACE pauses, R resets, V toggles frames); any other
        value records env 0's states and writes them to that path with
        `viz.render.render_episode`.  Rendering needs matplotlib: without
        it this raises before the first step."""
        cfg = self.cfg
        live = frames = None
        if cfg.render:
            from bez_isaacgym_tpu_torch.viz.render import require_matplotlib
            require_matplotlib()
            if cfg.render == "live":
                from bez_isaacgym_tpu_torch.viz.live import LiveViewer
                live = LiveViewer()
            else:
                frames = []
        num_steps = num_steps or cfg.play_steps
        ts, env_state, obs, gen = self._init_states()
        carry = self.ppo.initial_carry() if self.recurrent else None
        f64 = dict(dtype=torch.float64, device=self.device)
        total_reward = torch.zeros(cfg.num_envs, **f64)
        ep_reward_sum = torch.zeros((), **f64)
        episodes = torch.zeros((), dtype=torch.int64, device=self.device)
        last_r0 = 0.0   # env 0's step reward for the live reward strip
        t = 0
        for _ in range(num_steps):
            if live is not None:
                if live.quit_requested:   # ESC (vec_task.py:200,386-387)
                    break
                live.wait_if_paused()
                if live.pop_reset():
                    env_state, obs = self._reset(torch.Generator(
                        device=self.device).manual_seed(int(time.time())))
                live.publish(self.task.model, self._env0(env_state),
                             extra_title=f"t = {t / 60:.2f} s",
                             reward=last_r0)
                t += 1
            if frames is not None:
                frames.append(self._env0(env_state))
            if self.recurrent:
                actions, carry = self.ppo.act(ts, obs, carry, gen,
                                              deterministic)
            else:
                actions = self.ppo.act(ts, obs, gen, deterministic)
            out = self.task.step_batch(env_state, actions, gen)
            if self.recurrent:
                # RNN-state reset on done (play.py:196-199).
                carry = zero_done(carry, out.done)
            env_state, obs = out.state, out.obs
            if live is not None:
                last_r0 = float(out.reward[0])
            total_reward += out.reward
            ep_reward_sum += torch.where(out.done, total_reward, 0.0).sum()
            episodes += out.done.sum()
            total_reward = torch.where(out.done, 0.0, total_reward)
        n = int(episodes)
        mean_ep = float(ep_reward_sum) / max(1, n)
        print(f"played {num_steps} steps, {n} episodes, "
              f"mean episode reward {mean_ep:.2f}")
        self.played = {"steps": num_steps, "episodes": n,
                       "mean_episode_reward": mean_ep}
        if live is not None:
            live.close()
        if frames is not None:
            from bez_isaacgym_tpu_torch.viz.render import render_episode
            render_episode(self.task.model, frames, cfg.render)
            print(f"wrote episode render to {cfg.render}")
        return mean_ep

    @staticmethod
    def _env0(env_state):
        """Env 0's physics state on the CPU (a frame to draw)."""
        return tree_map(lambda x: x[0].cpu(), env_state.physics)
