"""Trajectory tracking evaluation (BASELINE.md: < 2% tracking error target).

Port of `bez_isaacgym_tpu/eval/tracking.py`.  Two oracles, both from the
reference's own control stack:
1. kick-skill joint tracking: play the simulation_rightkick keyframe skill
   through the physics (substeps=8) and measure joint-space error against
   the rate-limited plan (test_kick_env.py:210-222 is the reference's
   analog);
2. classical-walk tracking: drive the walking engine's plan closed-loop,
   with the walking IMU pitch PID on the arms every tick and partial
   (ff_alpha=0.3) computed-torque feedforward, and measure joint error and
   the final base position against the commanded goal, scaled by the
   odometry gain STRIDE_GAIN.

The methodology (feasible rate-limited oracle, computed-torque
feedforward, stride calibration, the ff_alpha frontier) is the JAX
package's; its module docstring and docs/TRACKING.json record why.

One env (B=1) runs through `step_batch`, the CUDA substep kernel on the
card.  The drive holds the episode open: it clears the done flag before
each step, so no auto-reset replaces the robot mid-plan (see `_drive`).

Run:  python -m bez_isaacgym_tpu_torch.eval.tracking [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from bez_isaacgym_tpu_torch import resolve_device
from bez_isaacgym_tpu_torch.control.controller import (SoccerbotController,
                                                       id_feedforward_targets)
from bez_isaacgym_tpu_torch.control.trajectories import Trajectory
from bez_isaacgym_tpu_torch.control.transformation import Transformation
from bez_isaacgym_tpu_torch.tasks.base import BezTask, EnvState, TaskConfig
from bez_isaacgym_tpu_torch.tasks.kick import KickTask
from bez_isaacgym_tpu_torch.tasks.walk import WalkTask

MAX_JOINT_VEL = 2.0 * np.pi      # actuator override, kick_env.py:327
STRIDE_GAIN = 0.5 / 0.465        # odometry gain, measured once (JAX package)


def rate_limited_oracle(plan: np.ndarray, dt: float,
                        vmax: float = MAX_JOINT_VEL) -> np.ndarray:
    """The trajectory an ideal vmax-limited servo would execute."""
    out = np.zeros_like(plan)
    out[0] = plan[0]
    for i in range(1, len(plan)):
        out[i] = out[i - 1] + np.clip(plan[i] - out[i - 1],
                                      -vmax * dt, vmax * dt)
    return out


def _start(task: BezTask):
    """One env at the ready pose, at rest, and the generator of its
    steps (the JAX drive starts from reset_one(PRNGKey(0)) with q set to
    the default pose and qd to 0)."""
    gen = torch.Generator(device=task.device).manual_seed(0)
    state = task.reset(gen, 1)
    ph = state.physics
    state = state._replace(physics=ph._replace(
        q=task.default_dof_pos[None].clone(), qd=torch.zeros_like(ph.qd)))
    return state, gen


def _step(task: BezTask, state: EnvState, target: np.ndarray,
          default: np.ndarray, gen: torch.Generator) -> EnvState:
    """One control step toward the (18,) joint target.  The done flag is
    cleared first: a tracking run measures the plan, and an auto-reset
    would swap in a fresh robot.  The JAX drive's episodes never end on
    the reference runs (its walk goal from PRNGKey(0) lies behind the
    walk, so the heading test never fires); a goal drawn by the port's
    generator might end one, and then the two would measure different
    things."""
    action = torch.as_tensor((target - default).astype(np.float32),
                             device=task.device)[None]
    state = state._replace(done=torch.zeros_like(state.done))
    return task.step_batch(state, action, gen).state


def _drive(task: BezTask, plan_cmd: np.ndarray):
    """Feed a (T,18) joint-target plan into the env; return achieved (T,18)
    and the final state.  The joint angles stay on the device until the
    end."""
    state, gen = _start(task)
    default = task.default_dof_pos.cpu().numpy()
    achieved = torch.empty((len(plan_cmd), task.model.nq),
                           device=task.device)
    for i, target in enumerate(plan_cmd):
        state = _step(task, state, target, default, gen)
        achieved[i] = state.physics.q[0]
    return achieved.cpu().numpy().astype(plan_cmd.dtype), state


def _rel_err(achieved: np.ndarray, desired: np.ndarray):
    """(per-joint mean ratio, per-joint rms) over moving joints."""
    err = achieved - desired
    joint_range = desired.max(0) - desired.min(0) + 1e-6
    rms = np.sqrt((err ** 2).mean(0))
    moving = joint_range > 0.05
    return float((rms[moving] / joint_range[moving]).mean()), rms


def _nrmse(achieved: np.ndarray, desired: np.ndarray) -> float:
    """Aggregate normalized RMS over moving joints."""
    joint_range = desired.max(0) - desired.min(0) + 1e-6
    moving = joint_range > 0.05
    err = (achieved - desired)[:, moving]
    return float(np.sqrt((err ** 2).mean()) / joint_range[moving].mean())


def kick_skill_tracking(use_kernel: bool = True, device="cuda") -> dict:
    """Joint tracking of the rightkick keyframe skill."""
    dev = resolve_device(device)
    tr = Trajectory("simulation_rightkick")
    t60 = np.arange(0.0, tr.max_time, 1 / 60)
    raw = np.stack([tr.angles_at(t) for t in t60])
    oracle = rate_limited_oracle(raw, 1 / 60)
    # 60 Hz control, 8 internal substeps (the JAX package's accuracy knob
    # of its compliant-contact engine).
    task = KickTask(TaskConfig(substeps=8, use_kernel=use_kernel),
                    device=dev)
    cmd = id_feedforward_targets(task, t60, raw)
    achieved, _ = _drive(task, cmd)
    rel, rms = _rel_err(achieved, oracle)
    return {"kick_joint_rms_rad": float(rms.mean()),
            "kick_rel_tracking_err": rel,
            "kick_nrmse": _nrmse(achieved, oracle)}


def walk_tracking(goal_x: float = 0.5, ff_alpha: float = 0.3,
                  imu_feedback: bool = True, stance_gain: float = 0.0,
                  use_kernel: bool = True, device="cuda") -> dict:
    """Classical walk: joint tracking + final base position error.

    Driven closed-loop the way the reference drives its own robot (the
    walking IMU pitch PID on the arms every tick,
    soccerbot_controller.py:27-45) with partial computed-torque
    feedforward (ff_alpha).  stance_gain > 0 stiffens the stance leg's
    servos by (1 + stance_gain), kd matched by its square root (the JAX
    package's contact-phase gain-scheduling option)."""
    from bez_isaacgym_tpu_torch.control.soccerbot import Joints, Soccerbot
    from bez_isaacgym_tpu_torch.ops.quat import quat_axis

    dev = resolve_device(device)
    ctrl = SoccerbotController()
    times, angles = ctrl.plan_joint_trajectory(
        Transformation.from_xy_theta(goal_x * STRIDE_GAIN, 0.0, 0.0))
    t60 = np.arange(0, times[-1], 1 / 60)
    raw = np.stack([np.interp(t60, times, angles[:, j]) for j in range(18)],
                   axis=1)
    oracle = rate_limited_oracle(raw, 1 / 60)
    task = WalkTask(TaskConfig(substeps=4, episode_length_s=60.0,
                               use_kernel=use_kernel),
                    device=dev)
    cmd = raw if ff_alpha == 0.0 else (
        raw + ff_alpha * (id_feedforward_targets(task, t60, raw) - raw))

    if imu_feedback:
        bot = Soccerbot()
        state, gen = _start(task)
        default = task.default_dof_pos.cpu().numpy()
        achieved = torch.empty((len(cmd), task.model.nq), device=task.device)
        kp0 = state.dyn.kp.cpu().numpy()
        kd0 = state.dyn.kd.cpu().numpy()
        lf, rf = task._foot_bodies
        left_leg = slice(Joints.LEFT_LEG_1, Joints.LEFT_LEG_6 + 1)
        right_leg = slice(Joints.RIGHT_LEG_1, Joints.RIGHT_LEG_6 + 1)
        for i in range(len(cmd)):
            t = cmd[i].copy()
            # Walking stabilizer (soccerbot.py:415-457): pitch PID -> arms.
            x_axis = quat_axis(state.physics.base_quat, 0)[0].cpu().numpy()
            pitch = float(-np.arcsin(np.clip(x_axis[2], -1.0, 1.0)))
            F = bot.apply_imu_feedback(pitch)
            t[Joints.LEFT_ARM_1] += 5.0 * F
            t[Joints.RIGHT_ARM_1] += 5.0 * F
            if stance_gain:
                cf = state.physics.body_contact_force[0].cpu().numpy()
                kp, kd = kp0.copy(), kd0.copy()
                scale = 1.0 + stance_gain
                if cf[lf, 2] > 1.0:
                    kp[:, left_leg] *= scale
                    kd[:, left_leg] *= np.sqrt(scale)
                if cf[rf, 2] > 1.0:
                    kp[:, right_leg] *= scale
                    kd[:, right_leg] *= np.sqrt(scale)
                state = state._replace(dyn=state.dyn._replace(
                    kp=torch.as_tensor(kp, device=task.device),
                    kd=torch.as_tensor(kd, device=task.device)))
            state = _step(task, state, t, default, gen)
            achieved[i] = state.physics.q[0]
        achieved = achieved.cpu().numpy().astype(cmd.dtype)
    else:
        achieved, state = _drive(task, cmd)
    rel, rms = _rel_err(achieved, oracle)
    final_x = float(state.physics.base_pos[0, 0])
    return {
        "walk_joint_rms_rad": float(rms.mean()),
        "walk_rel_tracking_err": rel,
        "walk_nrmse": _nrmse(achieved, oracle),
        "walk_goal_x_m": goal_x,
        "walk_final_x_m": final_x,
        "walk_position_err_frac": abs(final_x - goal_x) / goal_x,
        "walk_final_height_m": float(state.physics.base_pos[0, 2]),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--plain-engine", action="store_true",
                    help="step the plain PyTorch engine instead of the CUDA "
                         "substep kernel (to tell the kernel from the rest "
                         "of the port)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain engine")
    args = ap.parse_args(argv)
    kw = dict(use_kernel=not args.plain_engine, device=args.device)
    out = {}
    out.update(kick_skill_tracking(**kw))
    out.update(walk_tracking(**kw))
    return out


if __name__ == "__main__":
    print(json.dumps(main(), indent=1))
