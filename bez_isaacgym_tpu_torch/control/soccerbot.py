"""Kinematic Bez model + walking-engine state machine + stabilizer PIDs.

Semantics port of the reference Soccerbot
(resources/library/pycontrol/src/soccer_pycontrol/soccerbot.py), made
sim-agnostic: the IMU pose is supplied by the caller (our VecEnv, a real
robot, anything), instead of reaching into pybullet/isaacgym tensors.

Joint vector uses the canonical 18-DOF order of
bez_isaacgym_tpu_torch.models.bez.Joints.
"""

from __future__ import annotations

import numpy as np

from bez_isaacgym_tpu_torch.control import ik
from bez_isaacgym_tpu_torch.control.crotchpath import Robotpath
from bez_isaacgym_tpu_torch.control.transformation import Transformation
from bez_isaacgym_tpu_torch.models.bez import Joints

RIGHT_LEG = slice(Joints.RIGHT_LEG_1, Joints.RIGHT_LEG_6 + 1)
LEFT_LEG = slice(Joints.LEFT_LEG_1, Joints.LEFT_LEG_6 + 1)


class PID:
    """Incremental PID with output clamp (soccerbot.py:410-488 pattern)."""

    def __init__(self, kp: float, kd: float, ki: float, setpoint: float,
                 limit: float = 1.57):
        self.kp, self.kd, self.ki = kp, kd, ki
        self.setpoint = setpoint
        self.limit = limit
        self.reset()

    def reset(self):
        self.integral = 0.0
        self.last_error = 0.0

    def update(self, measurement: float) -> float:
        error = self.setpoint - measurement
        derivative = error - self.last_error
        out = self.kp * error + self.ki * self.integral + self.kd * derivative
        out = float(np.clip(out, -self.limit, self.limit))
        self.last_error = error
        self.integral += error
        return out


class Soccerbot:
    # Constants (soccerbot.py:62-68).
    standing_hip_height = 0.36
    walking_hip_height = 0.165
    foot_box = (0.09, 0.07, 0.01474)
    right_collision_center = (0.00385, 0.00401, -0.00737)
    arm_0_center = -0.45
    arm_1_center = np.pi * 0.8

    # Stabilizer gains (soccerbot.py:410-414, :461-464).
    WALK_PITCH_PID = (0.8, 0.0, 0.0005, -0.05)      # kp, kd, ki, setpoint
    STAND_PITCH_PID = (0.15, 0.0, 0.001, -0.05)

    HEAD_YAW_FREQ = 0.003     # soccerbot.py:500-501
    HIP_TO_TORSO_Z = 0.156    # |torso -> hip z| (soccerbot.py:91-92)

    def __init__(self, pose: Transformation | None = None):
        self.pose = pose or Transformation()
        self.foot_center_to_floor = \
            -self.right_collision_center[2] + self.foot_box[2]

        self.configuration = np.zeros(18)
        self.configuration_offset = np.zeros(18)
        self.robot_path: Robotpath | None = None
        self.current_step_time = 0.0
        self.head_step = 0

        kp, kd, ki, sp = self.WALK_PITCH_PID
        self.walk_pid = PID(kp, kd, ki, sp)
        kp, kd, ki, sp = self.STAND_PITCH_PID
        self.stand_pid = PID(kp, kd, ki, sp)

        # Feet rest poses below the torso (soccerbot.py:126-136).
        z = -(self.HIP_TO_TORSO_Z + self.walking_hip_height) \
            + self.foot_center_to_floor
        self.right_foot_init = Transformation(
            position=[ik.TORSO_TO_RIGHT_HIP[0], ik.TORSO_TO_RIGHT_HIP[1], z])
        self.left_foot_init = Transformation(
            position=[ik.TORSO_TO_RIGHT_HIP[0], -ik.TORSO_TO_RIGHT_HIP[1], z])

    def get_angles(self) -> np.ndarray:
        return self.configuration + self.configuration_offset

    # ------------------------------------------------------------------ pose
    def ready(self) -> None:
        """Standing pose via leg IK (soccerbot.py:153-181)."""
        position = self.pose.get_position()
        position[2] = self.HIP_TO_TORSO_Z + self.walking_hip_height
        self.pose.set_position(position)

        self.configuration[Joints.RIGHT_ARM_1] = self.arm_0_center
        self.configuration[Joints.LEFT_ARM_1] = self.arm_0_center
        self.configuration[Joints.RIGHT_ARM_2] = self.arm_1_center
        self.configuration[Joints.LEFT_ARM_2] = self.arm_1_center

        self.configuration[RIGHT_LEG] = ik.ik_right_foot(
            self.right_foot_init.copy())
        self.configuration[LEFT_LEG] = ik.ik_left_foot(
            self.left_foot_init.copy())

        self.configuration[Joints.HEAD_1] = 0.0
        self.configuration[Joints.HEAD_2] = 0.0
        self.configuration_offset[:] = 0.0

    # ------------------------------------------------------------------ plan
    def set_goal(self, finish: Transformation) -> Robotpath:
        """Plan a walking path to `finish` (soccerbot.py:253-275)."""
        pos = finish.get_position()
        pos[2] = self.HIP_TO_TORSO_Z + self.walking_hip_height
        finish.set_position(pos)
        # Keep only the yaw component (reference's euler index 0 in ZYX).
        yaw = finish.get_orientation_euler()[0]
        finish.set_orientation(
            Transformation.from_euler([yaw, 0, 0]).get_orientation())

        self.robot_path = Robotpath(self.pose.copy(), finish,
                                    self.foot_center_to_floor)
        self.current_step_time = 0.0
        return self.robot_path

    def step_path(self, t: float) -> None:
        """Joint configuration at path time t (soccerbot.py:277-299)."""
        assert self.robot_path is not None and t <= self.robot_path.duration()
        crotch = self.robot_path.crotch_position(t)
        right_T, left_T = self.robot_path.foot_position(t)
        torso_to_right = crotch.inv() @ right_T
        torso_to_left = crotch.inv() @ left_T
        self.configuration[RIGHT_LEG] = ik.ik_right_foot(torso_to_right)
        self.configuration[LEFT_LEG] = ik.ik_left_foot(torso_to_left)
        self.pose = crotch

    # ------------------------------------------------------------ stabilizers
    def apply_imu_feedback(self, pitch: float) -> float:
        """Walking stabilizer: pitch PID -> arm offsets (soccerbot.py:415-457)."""
        F = self.walk_pid.update(pitch)
        self.configuration_offset[Joints.LEFT_ARM_1] = 5.0 * F
        self.configuration_offset[Joints.RIGHT_ARM_1] = 5.0 * F
        return F

    def apply_imu_feedback_standing(self, pitch: float) -> float:
        """Standing stabilizer: pitch PID -> ankle offsets
        (soccerbot.py:459-488)."""
        F = self.stand_pid.update(pitch)
        self.configuration_offset[Joints.LEFT_LEG_5] = F
        self.configuration_offset[Joints.RIGHT_LEG_5] = F
        return pitch

    def reset_imus(self):
        self.walk_pid.reset()
        self.stand_pid.reset()

    # ---------------------------------------------------- pressure sensors
    # Corner layout looking from above (soccerbot.py:375-405):
    #   Left         Right
    # 4-------5    0-------1
    # |   ^   |    |   ^   |      ^
    # |   |   |    |   |   |      | : forward
    # 6-------7    2-------3
    def get_foot_pressure_sensors(self, sensor_normal,
                                  threshold: float = 0.5) -> np.ndarray:
        """Boolean 8-vector: is each foot corner touching the ground?

        Port of the reference's pybullet contact-point classifier
        (soccerbot.py:375-405); our engine already resolves contacts per
        cleat, so classification reduces to thresholding the per-corner
        normal force reported in PhysicsState.sensor_normal.  The env's
        sensor vector is ordered [left 4-7, right 0-3] (kick_env.py:467-478,
        models/bez.FOOT_SENSOR_MAP); pycontrol's convention is
        [right 0-3, left 4-7], so the halves are swapped here."""
        s = np.asarray(sensor_normal)
        return np.concatenate([s[4:8], s[0:4]]) > threshold

    def apply_foot_pressure_sensor_feedback(self, sensor_normal) -> np.ndarray:
        """Per-joint motor force budget given foot pressures
        (soccerbot.py:511-527).

        Faithful to the reference: its stance-ankle force reduction and
        walking-speed synchronization are commented out, so the function
        returns the unmodified per-joint effort limits; the sensor read
        is still performed (and exposed) like the original."""
        self.get_foot_pressure_sensors(sensor_normal)
        return np.full(len(self.configuration), 2.5)

    def apply_head_rotation(self):
        """Head scan pattern (soccerbot.py:500-509)."""
        self.configuration[Joints.HEAD_1] = \
            np.cos(self.head_step * self.HEAD_YAW_FREQ) * (np.pi / 3)
        self.configuration[Joints.HEAD_2] = 0.6
        self.head_step += 1
