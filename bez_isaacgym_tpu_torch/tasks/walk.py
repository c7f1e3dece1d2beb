"""bez_walk: walk to a randomized goal in [-2,2]^2.

Port of `bez_isaacgym_tpu/tasks/walk.py` (reference WalkEnv,
bez_isaacgym/tasks/walk_env.py): obs 52 (walk_env.py:103-105), a goal per
env at every reset (walk_env.py:570-574; the reference shares one sample
across the envs it resets, the JAX package draws per env, and so does the
port), reward and win state (walk_env.py:826-1030), batched over envs.
"""

from __future__ import annotations

import math

import torch

from bez_isaacgym_tpu_torch.ops import sensors
from bez_isaacgym_tpu_torch.ops.quat import quat_axis
from bez_isaacgym_tpu_torch.tasks.base import (BezTask, EnvState, TaskConfig,
                                               norm)


def walk_config() -> TaskConfig:
    # bez_walk.yaml: episode 10 s, goal default (2,0).
    return TaskConfig(episode_length_s=10.0, goal=(2.0, 0.0))


class WalkTask(BezTask):

    num_obs = 52
    has_ball = False

    def __init__(self, cfg: TaskConfig | None = None, device="cuda"):
        super().__init__(cfg or walk_config(), device=device)

    def task_reset(self, state: EnvState, gen: torch.Generator) -> EnvState:
        """A goal per env: uniform in the box [-goal_range, goal_range]^2,
        or, when goal_range_min > 0, at r uniform in [goal_range_min,
        goal_range] and a bearing uniform in [-pi, pi)."""
        cfg = self.cfg
        n, dev = state.goal.shape[0], state.goal.device
        if cfg.goal_range_min > 0.0:
            r = cfg.goal_range_min + (cfg.goal_range - cfg.goal_range_min) \
                * torch.rand(n, generator=gen, device=dev)
            th = math.pi * (2 * torch.rand(n, generator=gen, device=dev) - 1)
            goal = r[:, None] * torch.stack([torch.cos(th), torch.sin(th)],
                                            dim=-1)
        else:
            goal = cfg.goal_range * (
                2 * torch.rand((n, 2), generator=gen, device=dev) - 1)
        return state._replace(goal=goal)

    def observe(self, state: EnvState, action):
        ph = state.physics
        imu, new_prev = self._imu_and_heading(state)
        off_orn = sensors.compute_off_orn(ph.base_pos, ph.base_quat,
                                          state.goal)
        obs = torch.cat([ph.q, ph.qd, imu, off_orn, self._feet(state)],
                        dim=-1)
        return obs, state._replace(prev_lin_vel=new_prev)

    def reward_done(self, state: EnvState, action):
        """walk reward (walk_env.py:826-1030), "Variant Walking" branch."""
        cfg = self.cfg
        ph = state.physics
        f32 = ph.q.dtype
        bez_xy = ph.base_pos[:, 0:2]
        v_imu = ph.base_u[:, 0:3]
        w_imu = ph.base_u[:, 3:6]

        to_goal = state.goal - bez_xy
        to_goal_norm = norm(to_goal)
        unit = to_goal / to_goal_norm.clamp_min(1e-9)[:, None]
        velocity_forward = torch.sum(unit * v_imu[:, 0:2], dim=-1)

        up_proj = quat_axis(ph.base_quat, 2)[:, 2]

        vel_reward = norm(torch.cat([v_imu, w_imu], dim=-1))
        vel_lin = norm(v_imu)
        vel_ang = norm(w_imu)
        pos_reward = norm(self.default_dof_pos - ph.q)
        distance_to_height = torch.abs(1.0 - up_proj)

        # Near goal: hold still (walk_env.py:905-908,931-933).
        height_vel_pos = -(0.05 * vel_reward + 0.05 * pos_reward
                           + distance_to_height)
        # Far: goal-directed velocity x10 (walk_env.py:917-921).
        vel_height = (10.0 * velocity_forward
                      - (distance_to_height + 0.25 * pos_reward))
        reward = torch.where(to_goal_norm < 0.05, height_vel_pos, vel_height)
        if cfg.win_shaping:
            # Training-only shaping toward the win predicate (the JAX
            # package's TaskConfig.win_shaping): a proximity kernel sized to
            # the 5 cm win radius, doubled when the robot is also still and
            # near the default pose, gated on uprightness.
            upright = torch.clamp((up_proj - 0.7) / 0.25, 0.0, 1.0)
            prox = torch.exp(-(to_goal_norm / 0.08) ** 2)
            still = torch.exp(-(vel_lin / 0.3) ** 2 - (vel_ang / 1.0) ** 2
                              - (pos_reward / 1.0) ** 2)
            reward = reward + cfg.win_shaping * upright * prox \
                * (0.5 + 2.0 * still)

        done = state.done & False
        # Fall (walk_env.py:938-939).
        fell = up_proj < 0.7
        reward = torch.where(fell, -100.0, reward)
        done = done | fell
        # Win state: 4 conditions (walk_env.py:943-965).
        wins = ((to_goal_norm < 0.05).to(f32) + (pos_reward < 0.15).to(f32)
                + (vel_ang < 0.1).to(f32) + (vel_lin < 0.1).to(f32))
        won = wins == 4.0
        reward = torch.where(
            won,
            1000.0 - 1000.0 * state.progress.to(f32) / cfg.max_episode_length,
            reward)
        done = done | won
        # Heading deviated > pi/2 from the start->goal bearing
        # (walk_env.py:966-990; the start is taken as the origin).
        init_angle = torch.atan2(state.goal[:, 1], state.goal[:, 0])
        cur_angle = torch.atan2(unit[:, 1], unit[:, 0])
        strayed = torch.abs(init_angle - cur_angle) > 1.5708
        reward = torch.where(strayed, -100.0, reward)
        done = done | strayed
        # Horizon (walk_env.py:994-997).
        horizon = state.progress >= cfg.max_episode_length
        reward = torch.where(horizon, 0.0, reward)
        done = done | horizon
        return reward, done
