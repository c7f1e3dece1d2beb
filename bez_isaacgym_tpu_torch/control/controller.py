"""Walking controller: drives a VecEnv with the classical walking engine.

Port of `bez_isaacgym_tpu/control/controller.py` (reference
SoccerbotController, resources/library/pycontrol/src/soccer_pycontrol/
soccerbot_controller.py): 120 Hz loop time (PYBULLET_STEP 0.00833, :11),
env.step on the 0.02 s planner grid with IMU pitch feedback (:27-45),
actions = angles - default pose.  `SoccerbotController`,
`plan_joint_trajectory` and `feedforward_targets` are numpy, copied;
`make_tau_fn` and `id_feedforward_targets` run the port's own kinematics
and dynamics in torch, batched over the plan's points on a leading axis.
"""

from __future__ import annotations

import numpy as np
import torch

from bez_isaacgym_tpu_torch.control.soccerbot import Soccerbot
from bez_isaacgym_tpu_torch.control.transformation import Transformation

CONTROL_STEP = 0.00833   # soccerbot_controller.py:11


class SoccerbotController:

    def __init__(self, env=None):
        self.soccerbot = Soccerbot(Transformation())
        self.env = env

    def ready(self):
        self.soccerbot.ready()

    def set_goal(self, goal: Transformation):
        self.soccerbot.set_goal(goal)

    def _env_pitch(self) -> float:
        """Pitch of env 0 from its base quaternion (the reference reads env
        0's IMU link: soccerbot.py:362-372)."""
        from scipy.spatial.transform import Rotation

        quat = self.env.state.physics.base_quat[0].cpu().numpy()
        return float(Rotation.from_quat(quat).as_euler("ZYX")[1])

    def run(self, use_imu_feedback: bool = True):
        """Walk the planned path against the env (soccerbot_controller:27-45)."""
        bot = self.soccerbot
        if bot.robot_path is None or bot.robot_path.duration() == 0:
            return
        default = self.env.task.default_dof_pos.cpu().numpy()
        t = 0.0
        while t <= bot.robot_path.duration():
            if bot.current_step_time <= t:
                bot.step_path(t)
                if use_imu_feedback and self.env is not None:
                    bot.apply_imu_feedback(self._env_pitch())
                action = bot.get_angles() - default
                self.env.step(np.tile(action, (self.env.num_envs, 1)))
                bot.current_step_time += bot.robot_path.step_size
            t += CONTROL_STEP

    def plan_joint_trajectory(self, goal: Transformation,
                              dt: float | None = None):
        """Bake the full walk into (times, angles(T,18)) without an env."""
        bot = self.soccerbot
        bot.ready()
        bot.set_goal(goal)
        dt = dt or bot.robot_path.step_size
        duration = bot.robot_path.duration()
        if duration == 0:
            # Goal == start: nothing to walk (reference parity — the run
            # loop early-returns on zero-duration paths,
            # soccerbot_controller.py:28-30); hold the ready pose.
            return np.array([0.0]), bot.get_angles()[None].copy()
        times = np.arange(0.0, duration + 1e-9, dt)
        angles = np.zeros((len(times), 18))
        for i, t in enumerate(times):
            bot.step_path(min(t, duration))
            angles[i] = bot.get_angles()
        return times, angles


def feedforward_targets(times: np.ndarray, angles: np.ndarray,
                        kp: float = 100.0, kd: float = 7.5,
                        h: float = 1.0 / 240.0) -> np.ndarray:
    """Velocity-lead feedforward for Stable-PD position tracking.

    The engine's Stable-PD torque is kp*(target - q) - (h*kp + kd)*qd
    (ops/engine.py); in steady tracking (q ~ q_des, qd ~ qd_des) the damping
    term causes a lag of (h*kp + kd)/kp * qd_des.  Commanding
        target = q_des + (h*kp + kd)/kp * qd_des
    cancels it exactly.

    times/angles: the planner output (T,), (T, 18); h: physics substep.
    Returns the lead-compensated (T, 18) target plan.
    """
    qd = np.gradient(angles, times, axis=0)
    lead = (h * kp + kd) / kp
    return angles + lead * qd


def make_tau_fn(task, include_bias: bool = True):
    """Inverse-dynamics torque along desired trajectory points.

    Returns tau_of(q, qd, qdd) -> (T, 18) required joint torques for (T, 18)
    inputs, with the base assumed stationary at the task's initial pose:
        tau_req = (H(q_des) @ [0, qdd_des] + bias(q_des, qd_des))[6:]
    """
    from bez_isaacgym_tpu_torch.ops import dynamics as dyn
    from bez_isaacgym_tpu_torch.ops import kinematics as kin

    model, params = task.model, task.base_params
    mask = kin.ancestor_mask(model)

    def tau_of(q, qdv, qddv):
        n = q.shape[0]
        zeros6 = torch.zeros((n, 6), dtype=q.dtype, device=q.device)

        def at_init(x):
            return torch.as_tensor(x, dtype=q.dtype,
                                   device=q.device).expand(n, len(x))

        frames = kin.forward_kinematics(model, q,
                                        at_init(task.cfg.bez_init_pos),
                                        at_init(task.cfg.bez_init_rot))
        J_lin, J_ang = kin.com_jacobians(model, frames, mask)
        vel = dyn.body_velocities(J_lin, J_ang, torch.cat([zeros6, qdv], -1))
        m, I_w = dyn.world_inertias(model, frames, params.mass_scale)
        alpha0, a0 = dyn.bias_accelerations(model, frames, vel, qdv)
        H = dyn.mass_matrix(J_lin, J_ang, m, I_w,
                            params.armature.expand(n, -1))
        udot = torch.cat([zeros6, qddv], -1)
        tau = torch.einsum("tvw,tw->tv", H, udot)[:, 6:]
        if include_bias:
            bias = dyn.bias_force(J_lin, J_ang, m, I_w, vel, alpha0, a0,
                                  params.gravity)
            tau = tau + bias[:, 6:]
        return tau

    return tau_of


def id_feedforward_targets(task, times: np.ndarray, angles: np.ndarray,
                           include_bias: bool = True) -> np.ndarray:
    """Computed-torque feedforward via the engine's own inverse dynamics.

    Required joint torque along the desired trajectory (base assumed
    stationary, qdd from finite differences):
        tau_req = (H(q_des) @ [0, qdd_des] + bias(q_des, qd_des))[6:]
    Commanding
        target = q_des + ((h*kp + kd)*qd_des + tau_req) / kp
    turns the engine's Stable-PD into a full computed-torque controller:
        tau = kp*(q_des - q) + (h*kp + kd)*(qd_des - qd) + tau_req.
    The torques are computed in f32 on the task's device, every plan point
    in one batch.
    """
    params = task.base_params
    kp = params.kp.cpu().numpy()
    kd = params.kd.cpu().numpy()
    h = task.cfg.dt / task.cfg.substeps
    qd = np.gradient(angles, times, axis=0)
    qdd = np.gradient(qd, times, axis=0)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=task.device)

    tau_req = make_tau_fn(task, include_bias)(f32(angles), f32(qd), f32(qdd))
    return angles + ((h * kp + kd) * qd + tau_req.cpu().numpy()) / kp
