"""The Bez humanoid: canonical model loading and task constants.

Mirrors the reference's asset-variant selection (kick_env.py:258-302,
bez_kick.yaml:115-123) and actuator overrides (kick_env.py:322-329), and the
`Joints` DOF enum (kick_env.py:23-41).
"""

from __future__ import annotations

import enum
import os

import numpy as np

from portbench.reference.models.robot import DynParams, RobotModel, build_robot_model
from portbench.reference.models.urdf import RobotSpec

ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "assets")

NUM_JOINTS = 18


class Joints(enum.IntEnum):
    """Canonical DOF order (= alphabetical joint names, Isaac Gym parity)."""

    HEAD_1 = 0
    HEAD_2 = 1
    LEFT_ARM_1 = 2
    LEFT_ARM_2 = 3
    LEFT_LEG_1 = 4
    LEFT_LEG_2 = 5
    LEFT_LEG_3 = 6
    LEFT_LEG_4 = 7
    LEFT_LEG_5 = 8
    LEFT_LEG_6 = 9
    RIGHT_ARM_1 = 10
    RIGHT_ARM_2 = 11
    RIGHT_LEG_1 = 12
    RIGHT_LEG_2 = 13
    RIGHT_LEG_3 = 14
    RIGHT_LEG_4 = 15
    RIGHT_LEG_5 = 16
    RIGHT_LEG_6 = 17


# Reference foot-sensor slot layout (kick_env.py:467-478 + slices :187-196):
# obs feet vector = [left cleats 4,5,6,7, right cleats 0,1,2,3].
FOOT_SENSOR_MAP = {
    "left_foot_cleat_4": 0,
    "left_foot_cleat_5": 1,
    "left_foot_cleat_6": 2,
    "left_foot_cleat_7": 3,
    "right_foot_cleat_0": 4,
    "right_foot_cleat_1": 5,
    "right_foot_cleat_2": 6,
    "right_foot_cleat_3": 7,
}

# Actuator constants (kick_env.py:99-102, :322-329).
MX_28_VELOCITY = 2.0 * np.pi
DEFAULT_KP = 100.0
DEFAULT_KD = 7.5
DEFAULT_EFFORT = 2.5
DEFAULT_ARMATURE = 0.001
DEFAULT_JOINT_FRICTION = 0.1

# Ball (resources/assets/objects/ball.urdf).
BALL_RADIUS = 0.08
BALL_MASS = 0.3
BALL_INERTIA = 0.00128
BALL_ROLLING_FRICTION = 0.01

# Heights (bez_kick.yaml:19, kick_env.py:1125).
INIT_HEIGHT = 0.34
READY_HEIGHT = 0.325

# Named poses (cfg/task/bez_kick.yaml:40-78).
DEFAULT_JOINT_ANGLES = {name: 0.0 for name in (
    "head_motor_0", "head_motor_1",
    "left_arm_motor_0", "left_arm_motor_1",
    "right_arm_motor_0", "right_arm_motor_1",
    "left_leg_motor_0", "left_leg_motor_1", "left_leg_motor_2",
    "left_leg_motor_3", "left_leg_motor_4", "left_leg_motor_5",
    "right_leg_motor_0", "right_leg_motor_1", "right_leg_motor_2",
    "right_leg_motor_3", "right_leg_motor_4", "right_leg_motor_5",
)}

READY_JOINT_ANGLES = dict(DEFAULT_JOINT_ANGLES)
READY_JOINT_ANGLES.update({
    "left_leg_motor_2": 0.564, "left_leg_motor_3": -1.176,
    "left_leg_motor_4": 0.613,
    "right_leg_motor_2": 0.564, "right_leg_motor_3": -1.176,
    "right_leg_motor_4": 0.613,
    "left_arm_motor_1": 1.5, "right_arm_motor_1": 1.5,
})


def load_spec(variant: str = "stl") -> RobotSpec:
    path = os.path.join(ASSET_DIR, f"bez_{variant}.json")
    with open(path) as f:
        return RobotSpec.from_json(f.read())


def load_bez_model(variant: str = "stl", cleats: bool | None = None) -> RobotModel:
    """Load a Bez RobotModel.

    variant: "box" | "box_sensor" | "stl" | "stl_sensor" (the four specs
    this package ships in its assets/).
    The reference default task config uses stl=True, cleats=False ->
    soccerbot_stl.urdf (bez_kick.yaml:122-123, kick_env.py:267-276).
    """
    spec = load_spec(variant)
    model = build_robot_model(spec, foot_sensor_map=FOOT_SENSOR_MAP)
    assert model.nq == NUM_JOINTS, (model.nq, model.joint_names)
    # Sanity: canonical order matches the Joints enum.
    assert model.joint_names[Joints.HEAD_1] == "head_motor_0"
    assert model.joint_names[Joints.LEFT_LEG_1] == "left_leg_motor_0"
    assert model.joint_names[Joints.RIGHT_LEG_6] == "right_leg_motor_5"
    return model


def pose_vector(model: RobotModel, named_angles: dict[str, float]) -> np.ndarray:
    """Named joint angles -> (nq,) vector in canonical DOF order
    (parity with kick_env.py:204-209)."""
    q = np.zeros(model.nq)
    for name, angle in named_angles.items():
        q[model.joint_index(name)] = angle
    return q


def default_dyn_params(model: RobotModel, ground_friction: float = 1.0,
                       restitution: float = 0.0) -> DynParams:
    nq, nb = model.nq, model.nb
    return DynParams(
        kp=np.full(nq, DEFAULT_KP),
        kd=np.full(nq, DEFAULT_KD),
        effort=np.full(nq, DEFAULT_EFFORT),
        armature=np.full(nq, DEFAULT_ARMATURE),
        joint_friction=np.full(nq, DEFAULT_JOINT_FRICTION),
        mass_scale=np.ones(nb),
        ground_friction=ground_friction,
        restitution=restitution,
        gravity=np.array([0.0, 0.0, -9.81]),
        dof_lower=np.asarray(model.dof_lower, np.float64).copy(),
        dof_upper=np.asarray(model.dof_upper, np.float64).copy(),
    )
