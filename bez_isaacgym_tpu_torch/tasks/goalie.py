"""bez_goalie: block a ball shot at the robot at -10 m/s.

Port of `bez_isaacgym_tpu/tasks/goalie.py`, the JAX package's restoration
of the reference GoalieEnv from its task spec: resources/config/
bez_goalie.yaml (ball at (2,0,0.1) with vx=-10: :17-21; plane friction
0.35: :7-8; bez at z=0.29: :12; Kd=0: :26; episode 25 s: :99; the box
model: :106) and the reward kernel (goalie_env.py:528-651), batched over
envs.  The goal is the shot origin (2, 0), as in the JAX package.
"""

from __future__ import annotations

import torch

from bez_isaacgym_tpu_torch.ops import sensors
from bez_isaacgym_tpu_torch.tasks.base import (BezTask, EnvState, TaskConfig,
                                               norm, unit)

DESIRED_HEIGHT = 0.27  # goalie_env.py:561


def goalie_config() -> TaskConfig:
    return TaskConfig(
        episode_length_s=25.0,
        damping=0.0,
        plane_static_friction=0.35,
        bez_init_pos=(0.0, 0.0, 0.29),
        ball_init_pos=(2.0, 0.0, 0.1),
        ball_init_vel=(-10.0, 0.0, 0.0),
        goal=(2.0, 0.0),
        stl=False, cleats=False,   # soccerbot_box.urdf (bez_goalie.yaml:106)
    )


class GoalieTask(BezTask):

    num_obs = 54
    has_ball = True

    def __init__(self, cfg: TaskConfig | None = None, device="cuda"):
        super().__init__(cfg or goalie_config(), device=device)

    def observe(self, state: EnvState, action):
        ph = state.physics
        imu, new_prev = self._imu_and_heading(state)
        off_orn = sensors.compute_off_orn(ph.base_pos, ph.base_quat,
                                          state.goal)
        obs = torch.cat([ph.q, ph.qd, imu, off_orn, self._feet(state),
                         state.ball_init], dim=-1)
        return obs, state._replace(prev_lin_vel=new_prev)

    def reward_done(self, state: EnvState, action):
        """goalie reward (goalie_env.py:528-651), exact scales and order."""
        cfg = self.cfg
        ph = state.physics
        bez_xy = ph.base_pos[:, 0:2]
        ball_xy = ph.ball_pos[:, 0:2]
        v_imu = ph.base_u[:, 0:3]
        w_imu = ph.base_u[:, 3:6]

        to_ball = ball_xy - bez_xy
        velocity_forward = torch.sum(unit(to_ball) * v_imu[:, 0:2], dim=-1)

        ball_velocity_forward = torch.sum(
            unit(state.goal - ball_xy) * ph.ball_vel[:, 0:2], dim=-1)
        ball_speed = norm(ph.ball_vel[:, 0:2])

        vel_reward = 0.05 * norm(w_imu)
        pos_reward = 0.05 * norm(self.default_dof_pos - ph.q)
        distance_to_height = DESIRED_HEIGHT - ph.base_pos[:, 2]   # signed
        distance_kicked = norm(ball_xy - state.ball_init)

        # goalie_env.py:572-581 (vel_pos = vel - pos, and
        # height_vel_pos = height - vel_pos).
        vel_pos = vel_reward - pos_reward
        height_vel_pos = distance_to_height - vel_pos
        ball_height_vel_pos = 0.2 * ball_velocity_forward - height_vel_pos
        vel_height = 0.05 * velocity_forward - distance_to_height
        ball_vel_height = 0.2 * ball_velocity_forward + vel_height
        reward = torch.where(distance_kicked > 0.3, ball_height_vel_pos,
                             ball_vel_height)

        done = state.done & False
        # Ball got past the robot (goalie_env.py:625-632).
        passed = to_ball[:, 0] < 0.0
        reward = torch.where(passed, -10000.0, reward)
        done = done | passed
        # Ball stopped: episode over, reward unchanged (goalie_env.py:638-639).
        done = done | (ball_speed < 0.05)
        # Horizon (goalie_env.py:645-649).
        horizon = state.progress >= cfg.max_episode_length
        reward = torch.where(horizon, 0.0, reward)
        done = done | horizon
        return reward, done
