"""Keyframe skill playback (kicks, get-ups, goalie dives).

Copy of `bez_isaacgym_tpu/control/trajectories.py` (numpy, host side):
linear interpolation between keyframes, padded with the ready pose at both
ends, 120 Hz publishing as position offsets from the default pose, optional
left/right mirroring (arm<->arm and leg<->leg).  Skills load from the
port's copy of the JSON assets, `assets/trajectories/`.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from bez_isaacgym_tpu_torch.models.bez import READY_JOINT_ANGLES

ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "assets",
                         "trajectories")
PUBLISH_STEP = 0.00833
TIME_TO_LAST_POSE = 1.0   # soccer_trajectories.py:23

_CANONICAL = [
    "head_motor_0", "head_motor_1",
    "left_arm_motor_0", "left_arm_motor_1",
    "left_leg_motor_0", "left_leg_motor_1", "left_leg_motor_2",
    "left_leg_motor_3", "left_leg_motor_4", "left_leg_motor_5",
    "right_arm_motor_0", "right_arm_motor_1",
    "right_leg_motor_0", "right_leg_motor_1", "right_leg_motor_2",
    "right_leg_motor_3", "right_leg_motor_4", "right_leg_motor_5",
]


def available_skills() -> list[str]:
    return sorted(f[:-5] for f in os.listdir(ASSET_DIR)
                  if f.endswith(".json"))


class Trajectory:
    """Interpolated multi-joint keyframe trajectory."""

    def __init__(self, skill: str, mirror: bool = False):
        path = os.path.join(ASSET_DIR, f"{skill}.json")
        with open(path) as f:
            data = json.load(f)
        self.name = data["name"]
        self.mirror = mirror
        raw_times = list(data["times"])
        # Pad with ready pose at t=0 and t=end+1 (soccer_trajectories:34-43).
        self.times = np.array([0.0] + raw_times
                              + [raw_times[-1] + TIME_TO_LAST_POSE])
        self.max_time = float(self.times[-1])
        self.keyframes = {}
        for joint, values in data["joints"].items():
            ready = READY_JOINT_ANGLES.get(joint, 0.0)
            self.keyframes[joint] = np.array([ready] + list(values) + [ready])

    def joints(self):
        return self.keyframes.keys()

    def setpoint(self, t: float) -> dict[str, float]:
        t = float(np.clip(t, self.times[0], self.times[-1]))
        return {j: float(np.interp(t, self.times, v))
                for j, v in self.keyframes.items()}

    def angles_at(self, t: float) -> np.ndarray:
        """(18,) canonical joint vector at time t."""
        sp = self.setpoint(t)
        out = np.zeros(18)
        for joint, value in sp.items():
            out[_CANONICAL.index(joint)] = value
        if self.mirror:
            out = mirror_angles(out)
        return out

    def as_array(self, dt: float = PUBLISH_STEP):
        """(times, (T,18)) densely sampled."""
        times = np.arange(0.0, self.max_time, dt)
        return times, np.stack([self.angles_at(t) for t in times])

    def publish(self, env, dt: float = PUBLISH_STEP):
        """Drive a VecEnv at 120 Hz (soccer_trajectories.py:55-91)."""
        default = env.task.default_dof_pos.cpu().numpy()
        t = 0.0
        while t < self.max_time:
            action = (self.angles_at(t) - default).astype(np.float32)
            env.step(torch.as_tensor(action, device=env.device)
                     .expand(env.num_envs, 18))
            t += dt


def mirror_angles(angles: np.ndarray) -> np.ndarray:
    """Swap left/right arm and leg joint groups."""
    out = angles.copy()
    out[2:4], out[10:12] = angles[10:12], angles[2:4]      # arms
    out[4:10], out[12:18] = angles[12:18], angles[4:10]    # legs
    return out


class SoccerTrajectoryClass:
    """Facade parity with soccer_trajectories.py:94-112."""

    def __init__(self, env):
        self.env = env

    def run_trajectory(self, command: str):
        skill = f"simulation_{command}"
        if skill not in available_skills():
            return False
        Trajectory(skill).publish(self.env)
        return True
