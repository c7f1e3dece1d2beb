"""MPC warm starts from the classical control stack.

Port of `bez_isaacgym_tpu/control/warmstart.py` (numpy, host side): (S, H,
nq) joint-position offsets from the ready pose, what
`BezTask._pre_physics` consumes, from the two classical generators:

- `walk_warm_start`: the walking engine's joint plan toward per-env goals
  (path/footpath/crotchpath + closed-form IK), resampled onto the MPC grid;
- `skill_warm_start`: a keyframe skill (e.g. simulation_rightkick)
  resampled onto the MPC grid.
"""

from __future__ import annotations

import numpy as np

from bez_isaacgym_tpu_torch.control.controller import SoccerbotController
from bez_isaacgym_tpu_torch.control.trajectories import Trajectory
from bez_isaacgym_tpu_torch.control.transformation import Transformation


def _resample(times: np.ndarray, angles: np.ndarray, horizon: int,
              dt: float, t0: float = 0.0) -> np.ndarray:
    """(H, 18) plan window starting at t0, held at the final pose after."""
    grid = t0 + dt * np.arange(horizon)
    grid = np.clip(grid, times[0], times[-1])
    return np.stack([np.interp(grid, times, angles[:, j])
                     for j in range(angles.shape[1])], axis=1)


def walk_warm_start(task, goals: np.ndarray, horizon: int,
                    dt: float = 1.0 / 60.0, t0: float = 0.0) -> np.ndarray:
    """(S, H, nq) walking-gait nominals toward per-env (x, y, theta) goals."""
    default = task.default_dof_pos.cpu().numpy()
    out = np.zeros((len(goals), horizon, task.num_actions), np.float32)
    for i, (x, y, theta) in enumerate(np.asarray(goals)):
        ctrl = SoccerbotController()
        times, angles = ctrl.plan_joint_trajectory(
            Transformation.from_xy_theta(float(x), float(y), float(theta)))
        out[i] = _resample(times, angles, horizon, dt, t0) - default
    return out


def _skill_angles(skill: str, dt: float):
    """(times, (T, 18)) of a keyframe skill sampled every dt."""
    tr = Trajectory(skill)
    tgrid = np.arange(0.0, tr.max_time, dt)
    return tgrid, np.stack([tr.angles_at(t) for t in tgrid])


def skill_warm_start(task, skill: str, horizon: int,
                     dt: float = 1.0 / 60.0, t0: float = 0.0,
                     num: int = 1) -> np.ndarray:
    """(S, H, nq) keyframe-skill nominals (same plan broadcast to S envs)."""
    plan = skill_warm_starts(task, skill, horizon, [t0], dt)[0]
    return np.broadcast_to(plan, (num, horizon, task.num_actions)).copy()


def skill_warm_starts(task, skill: str, horizon: int, t0s,
                      dt: float = 1.0 / 60.0) -> np.ndarray:
    """(T, H, nq): row i is `skill_warm_start(..., t0=t0s[i])[0]`, the skill
    sampled once for all T start times (a receding-horizon eval's plans)."""
    tgrid, angles = _skill_angles(skill, dt)
    default = task.default_dof_pos.cpu().numpy()
    return np.stack([(_resample(tgrid, angles, horizon, dt, t0) - default)
                     .astype(np.float32) for t0 in t0s])
