"""Sensor models: IMU, heading ("off orientation"), foot contact sensors.

Port of `bez_isaacgym_tpu/ops/sensors.py`, reproducing the reference
TorchScript sensor kernels' actual semantics (including documented quirks):

- compute_imu                     (kick_env.py:888-930)
- compute_off_orn                 (kick_env.py:933-962)
- compute_feet_sensors_cleats     (kick_env.py:1044-1069)
- compute_feet_sensors_no_cleats  (kick_env.py:966-1040)

Tensors carry a leading env axis (any leading dims).
"""

from __future__ import annotations

import torch

from portbench.reference.ops.quat import get_euler_xyz, imu_rotation_matrix

Tensor = torch.Tensor

# Limits (kick_env.py:99-102).
IMU_MAX_ANG_VEL = 8.7266
IMU_MAX_LIN_ACC = 2.0 * 9.81


def compute_imu(root_orient: Tensor, root_vel: Tensor, root_ang: Tensor,
                prev_lin_vel: Tensor, dt: float) -> tuple[Tensor, Tensor]:
    """IMU observation (..., 6) = [lin_acc(3), ang_vel(3)] and new
    prev_lin_vel.

    Reference quirks reproduced deliberately (kick_env.py:917-928):
    - "gravity" is the unit -z vector, not 9.81-scaled;
    - the rotation matrix interprets the xyzw quaternion with the wxyz
      formula (see ops.quat.imu_rotation_matrix);
    - angular velocity stays in the world frame.
    """
    lin_acc = (root_vel - prev_lin_vel) / dt
    down = torch.tensor([0.0, 0.0, -1.0], dtype=root_vel.dtype,
                        device=root_vel.device)
    lin_acc = lin_acc - down
    rot = imu_rotation_matrix(root_orient)
    lin_acc = torch.einsum("...ij,...j->...i", rot, lin_acc)
    lin_acc = lin_acc.clamp(-IMU_MAX_LIN_ACC, IMU_MAX_LIN_ACC)
    ang_vel = root_ang.clamp(-IMU_MAX_ANG_VEL, IMU_MAX_ANG_VEL)
    return torch.cat([lin_acc, ang_vel], dim=-1), root_vel


def compute_off_orn(root_pos: Tensor, root_orient: Tensor,
                    goal: Tensor) -> Tensor:
    """(..., 2) = (sin, -cos) of the angle between heading and the goal
    direction (kick_env.py:933-962)."""
    to_goal = goal - root_pos[..., 0:2]
    unit = to_goal / torch.linalg.norm(to_goal, dim=-1,
                                       keepdim=True).clamp_min(1e-9)
    _, _, yaw = get_euler_xyz(root_orient)
    d2 = torch.stack([torch.cos(yaw), torch.sin(yaw)], dim=-1)
    cos = torch.sum(d2 * unit, dim=-1)
    # |cross| of the z-padded vectors (kick_env.py:955-959).
    sin = torch.abs(unit[..., 0] * d2[..., 1] - unit[..., 1] * d2[..., 0])
    return torch.stack([sin, -cos], dim=-1)


def feet_sensors_cleats(sensor_normal: Tensor,
                        threshold: float = 1.0) -> Tensor:
    """(..., 8) in {-1, 1}: cleat contact-force norm > 1 N
    (kick_env.py:1053-1061)."""
    one = torch.ones_like(sensor_normal, dtype=torch.float32)
    return torch.where(sensor_normal > threshold, one, -one)


def _foot_case_table(force: Tensor) -> Tensor:
    """(..., 4) corner pattern from one foot's net contact force (..., 3).

    Port of compute_feet_sensors_no_cleats (kick_env.py:966-1040).  As
    written, the reference's case logic only distinguishes zero vs nonzero
    force components (cases 2,5,6,7,10 are unreachable); we reproduce that
    actual behavior, not the commented intent.
    """
    f = torch.where(torch.abs(force) > 0.01, force, torch.zeros_like(force))
    fx_nonzero = (torch.abs(f[..., 0]) > 0.0)[..., None]
    fy_nonzero = (torch.abs(f[..., 1]) > 0.0)[..., None]

    def case(*v):
        return torch.tensor(v, dtype=torch.float32, device=force.device)

    case_1 = case(1.0, -1.0, -1.0, -1.0)     # fx!=0, fy!=0
    case_3 = case(1.0, -1.0, 1.0, -1.0)      # fx!=0, fy==0
    case_9 = case(1.0, 1.0, -1.0, -1.0)      # fx==0, fy!=0
    case_11 = case(1.0, 1.0, 1.0, 1.0)       # fx==0, fy==0
    case_12 = case(-1.0, -1.0, -1.0, -1.0)   # fz < 1 N

    out = torch.where(fx_nonzero,
                      torch.where(fy_nonzero, case_1, case_3),
                      torch.where(fy_nonzero, case_9, case_11))
    return torch.where((f[..., 2] < 1.0)[..., None], case_12, out)


def feet_sensors_no_cleats(left_force: Tensor, right_force: Tensor) -> Tensor:
    """(..., 8) = [left 4 corners, right 4 corners] from per-foot net contact
    forces (kick_env.py:497-582)."""
    return torch.cat([_foot_case_table(left_force),
                      _foot_case_table(right_force)], dim=-1)
