"""bez_orient: turn in place to a goal yaw angle.

Port of `bez_isaacgym_tpu/tasks/orient.py` (reference OrientEnv,
bez_isaacgym/tasks/orient_env.py): obs 52 with the (cos, sin) off-angle
feature (orient_env.py:719-733) and the reward kernel
(orient_env.py:843-1046), batched over envs.  The reference's velocity
term is dead code (overwritten by -0.5*|angle error|, orient_env.py:920-921);
the effective behaviour is kept, and so are the signed `angle_to_goal <
0.05` tests.
"""

from __future__ import annotations

import torch

from bez_isaacgym_tpu_torch.ops.quat import (get_euler_xyz, normalize_angle,
                                             quat_axis)
from bez_isaacgym_tpu_torch.tasks.base import (BezTask, EnvState, TaskConfig,
                                               norm)


def orient_config() -> TaskConfig:
    # bez_orient.yaml: episode 10 s, goal_angle pi/2.
    return TaskConfig(episode_length_s=10.0, goal=(2.0, 0.0),
                      goal_angle=1.5708)


def compute_off_angle(base_quat: torch.Tensor, goal_angle: torch.Tensor):
    """((..., 2) = (cos, sin) of goal_angle - yaw, the signed difference)
    (orient_env.py:719-733)."""
    _, _, yaw = get_euler_xyz(base_quat)
    diff = goal_angle - normalize_angle(yaw)
    return torch.stack([torch.cos(diff), torch.sin(diff)], dim=-1), diff


class OrientTask(BezTask):

    num_obs = 52
    has_ball = False

    def __init__(self, cfg: TaskConfig | None = None, device="cuda"):
        super().__init__(cfg or orient_config(), device=device)

    def observe(self, state: EnvState, action):
        ph = state.physics
        imu, new_prev = self._imu_and_heading(state)
        off_angle, _ = compute_off_angle(ph.base_quat, state.goal_angle)
        obs = torch.cat([ph.q, ph.qd, imu, off_angle, self._feet(state)],
                        dim=-1)
        return obs, state._replace(prev_lin_vel=new_prev)

    def reward_done(self, state: EnvState, action):
        cfg = self.cfg
        ph = state.physics
        f32 = ph.q.dtype
        v_imu = ph.base_u[:, 0:3]
        w_imu = ph.base_u[:, 3:6]

        _, angle_to_goal = compute_off_angle(ph.base_quat, state.goal_angle)
        abs_angle = torch.abs(angle_to_goal)

        up_proj = quat_axis(ph.base_quat, 2)[:, 2]

        vel_reward = norm(torch.cat([v_imu, w_imu], dim=-1))
        vel_lin = norm(v_imu)
        vel_ang = norm(w_imu)
        pos_reward = norm(self.default_dof_pos - ph.q)
        distance_to_height = torch.abs(1.0 - up_proj)

        # Near goal: hold still (orient_env.py:911-913).
        height_vel_pos = -(0.05 * vel_reward + 0.05 * pos_reward
                           + distance_to_height)
        # Far: -0.5|angle| - height - 0.0025*pos (orient_env.py:920-924).
        vel_height = (-0.5 * abs_angle
                      - (distance_to_height + 0.05 * 0.05 * pos_reward))
        reward = torch.where(angle_to_goal < 0.05, height_vel_pos,
                             vel_height)

        done = state.done & False
        # Fall (orient_env.py:947-948).
        fell = up_proj < 0.7
        reward = torch.where(fell, -100.0, reward)
        done = done | fell
        # Win state (orient_env.py:950-972).
        wins = ((angle_to_goal < 0.05).to(f32) + (pos_reward < 0.15).to(f32)
                + (vel_ang < 0.1).to(f32) + (vel_lin < 0.1).to(f32))
        won = wins == 4.0
        reward = torch.where(
            won,
            1000.0 - 1000.0 * state.progress.to(f32) / cfg.max_episode_length,
            reward)
        done = done | won
        # Drift from start > 0.3 m -> -5 (orient_env.py:1000-1009).
        init_xy = torch.as_tensor(cfg.bez_init_pos[:2], dtype=f32,
                                  device=ph.base_pos.device)
        drifted = norm(ph.base_pos[:, 0:2] - init_xy) > 0.3
        reward = torch.where(drifted, -5.0, reward)
        done = done | drifted
        # Horizon (orient_env.py:1011-1014).
        horizon = state.progress >= cfg.max_episode_length
        reward = torch.where(horizon, 0.0, reward)
        done = done | horizon
        return reward, done
