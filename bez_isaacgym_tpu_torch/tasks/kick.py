"""bez_kick: kick the ball toward the goal.

Port of `bez_isaacgym_tpu/tasks/kick.py` (reference KickEnv,
bez_isaacgym/tasks/kick_env.py): obs 54 (kick_env.py:118-120, 1398-1417),
reward/termination (kick_env.py:1198-1395), batched over envs.
"""

from __future__ import annotations

import torch

from bez_isaacgym_tpu_torch.ops import sensors
from bez_isaacgym_tpu_torch.tasks.base import (BezTask, EnvState, TaskConfig,
                                               norm, unit)

DESIRED_HEIGHT = 0.325  # kick_env.py:1125


class KickTask(BezTask):

    num_obs = 54
    has_ball = True

    def __init__(self, cfg: TaskConfig | None = None, device="cuda"):
        super().__init__(cfg or TaskConfig(), device=device)
        # On the device once: `reward_done` makes no tensor from host data,
        # so that a CUDA graph can capture it.
        self._init_xy = torch.as_tensor(self.cfg.bez_init_pos[:2],
                                        dtype=torch.float32,
                                        device=self.device)

    def observe(self, state: EnvState, action):
        ph = state.physics
        imu, new_prev = self._imu_and_heading(state)
        off_orn = sensors.compute_off_orn(ph.base_pos, ph.base_quat,
                                          state.goal)
        obs = torch.cat([
            ph.q,                 # 18 dof pos
            ph.qd,                # 18 dof vel
            imu,                  # 6
            off_orn,              # 2
            self._feet(state),    # 8
            state.ball_init,      # 2
        ], dim=-1)
        return obs, state._replace(prev_lin_vel=new_prev)

    def reward_done(self, state: EnvState, action):
        """kick reward + reset chain (kick_env.py:1198-1395), exact scales
        and override order."""
        cfg = self.cfg
        ph = state.physics
        f32 = ph.q.dtype

        bez_xy = ph.base_pos[:, 0:2]
        ball_xy = ph.ball_pos[:, 0:2]
        v_imu = ph.base_u[:, 0:3]
        w_imu = ph.base_u[:, 3:6]

        velocity_forward = torch.sum(unit(ball_xy - bez_xy) * v_imu[:, 0:2],
                                     dim=-1)

        to_goal = state.goal - ball_xy
        to_goal_norm = norm(to_goal)
        ball_to_goal_unit = to_goal / to_goal_norm.clamp_min(1e-9)[:, None]
        ball_velocity_forward = torch.sum(
            ball_to_goal_unit * ph.ball_vel[:, 0:2], dim=-1)

        init_unit = unit(state.goal - state.ball_init)
        ball_to_goal_angle = torch.atan2(ball_to_goal_unit[:, 1],
                                         ball_to_goal_unit[:, 0])
        init_to_goal_angle = torch.atan2(init_unit[:, 1], init_unit[:, 0])
        goal_angle_diff = torch.abs(init_to_goal_angle - ball_to_goal_angle)

        vel_reward = 0.05 * norm(torch.cat([v_imu, w_imu], dim=-1))
        pos_reward = 0.05 * norm(self.default_dof_pos - ph.q)
        distance_to_height = torch.abs(DESIRED_HEIGHT - ph.base_pos[:, 2])
        distance_kicked = norm(ball_xy - state.ball_init)

        # After first ball displacement > 0.3 m vs before (kick_env.py:1304).
        ball_height_vel_pos = (0.1 * ball_velocity_forward
                               - (distance_to_height + vel_reward + pos_reward))
        ball_vel_height = (0.1 * ball_velocity_forward
                           + 0.05 * velocity_forward - distance_to_height)
        reward = torch.where(distance_kicked > 0.3, ball_height_vel_pos,
                             ball_vel_height)

        done = state.done & False  # fresh reset flags
        # Fall (kick_env.py:1331-1332).
        fell = ph.base_pos[:, 2] < 0.275
        reward = torch.where(fell, -1.0, reward)
        done = done | fell
        # Bez out of bound (kick_env.py:1340-1349).
        oob = norm(bez_xy - self._init_xy) > 0.5
        reward = torch.where(oob, -1.0, reward)
        done = done | oob
        # Ball direction out of bound (kick_env.py:1370-1377).
        angle_oob = goal_angle_diff > 1.5708
        reward = torch.where(angle_oob, -1.0, reward)
        done = done | angle_oob
        # Ball reached goal (kick_env.py:1380-1385).
        scored = to_goal_norm < 0.05
        reward = torch.where(
            scored,
            100.0 - 100.0 * state.progress.to(f32) / cfg.max_episode_length,
            reward)
        done = done | scored
        # Horizon (kick_env.py:1388-1391).
        horizon = state.progress >= cfg.max_episode_length
        reward = torch.where(horizon, 0.0, reward)
        done = done | horizon
        return reward, done
