"""Quaternion and rotation math, xyzw convention, on batched tensors.

Port of `bez_isaacgym_tpu/ops/quat.py`.  Every function operates on the
trailing axis and broadcasts over any leading batch dimensions.

Convention: quaternions are stored ``(x, y, z, w)`` (Isaac Gym order) unless a
function name says otherwise.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def cross(a: Tensor, b: Tensor) -> Tensor:
    """Cross product over the trailing axis, broadcasting the others."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_unit(q: Tensor) -> Tensor:
    """Normalize a quaternion."""
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-9)


def quat_conjugate(q: Tensor) -> Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_mul(a: Tensor, b: Tensor) -> Tensor:
    """Hamilton product a*b, xyzw."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vector v by quaternion q (body -> world if q is body pose)."""
    qvec = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * cross(qvec, v)
    return v + w * t + cross(qvec, t)


def quat_rotate_inverse(q: Tensor, v: Tensor) -> Tensor:
    return quat_rotate(quat_conjugate(q), v)


def quat_axis(q: Tensor, axis: int) -> Tensor:
    """Rotate the given basis axis (0=x,1=y,2=z) by q."""
    basis = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
    basis[..., axis] = 1.0
    return quat_rotate(q, basis)


def get_basis_vector(q: Tensor, v: Tensor) -> Tensor:
    """Reference `get_basis_vector` == rotate v by q (isaacgym.torch_utils)."""
    return quat_rotate(q, v)


def quat_to_matrix(q: Tensor) -> Tensor:
    """xyzw quaternion -> 3x3 rotation matrix (correct convention)."""
    x, y, z, w = q.unbind(-1)
    two_s = 2.0 / torch.sum(q * q, dim=-1).clamp_min(1e-12)
    o = torch.stack([
        1 - two_s * (y * y + z * z),
        two_s * (x * y - z * w),
        two_s * (x * z + y * w),
        two_s * (x * y + z * w),
        1 - two_s * (x * x + z * z),
        two_s * (y * z - x * w),
        two_s * (x * z - y * w),
        two_s * (y * z + x * w),
        1 - two_s * (x * x + y * y),
    ], dim=-1)
    return o.reshape(q.shape[:-1] + (3, 3))


def imu_rotation_matrix(q_xyzw: Tensor) -> Tensor:
    """Reproduces the reference IMU rotation exactly, including its quirk.

    The reference `quaternion_to_matrix` (kick_env.py:857-885) implements the
    wxyz formula but is fed Isaac Gym xyzw quaternions (kick_env.py:922), so
    the x-component lands in the scalar slot.
    """
    r, i, j, k = q_xyzw.unbind(-1)
    two_s = 2.0 / torch.sum(q_xyzw * q_xyzw, dim=-1).clamp_min(1e-12)
    o = torch.stack([
        1 - two_s * (j * j + k * k),
        two_s * (i * j - k * r),
        two_s * (i * k + j * r),
        two_s * (i * j + k * r),
        1 - two_s * (i * i + k * k),
        two_s * (j * k - i * r),
        two_s * (i * k - j * r),
        two_s * (j * k + i * r),
        1 - two_s * (i * i + j * j),
    ], dim=-1)
    return o.reshape(q_xyzw.shape[:-1] + (3, 3))


def matrix_to_quat(m: Tensor) -> Tensor:
    """3x3 rotation matrix -> xyzw quaternion (branch-free)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate computations; pick the numerically best by largest pivot.
    qw0 = torch.sqrt((1.0 + tr).clamp_min(1e-12)) / 2.0
    q0 = torch.stack([(m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0), qw0], dim=-1)

    qx1 = torch.sqrt((1.0 + m00 - m11 - m22).clamp_min(1e-12)) / 2.0
    q1 = torch.stack([qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1),
                      (m21 - m12) / (4 * qx1)], dim=-1)

    qy2 = torch.sqrt((1.0 - m00 + m11 - m22).clamp_min(1e-12)) / 2.0
    q2 = torch.stack([(m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2),
                      (m02 - m20) / (4 * qy2)], dim=-1)

    qz3 = torch.sqrt((1.0 - m00 - m11 + m22).clamp_min(1e-12)) / 2.0
    q3 = torch.stack([(m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3,
                      (m10 - m01) / (4 * qz3)], dim=-1)

    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0,
                    torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return quat_unit(q)


def quat_from_axis_angle(axis: Tensor, angle: Tensor) -> Tensor:
    """Unit axis + angle -> xyzw quaternion. angle may broadcast."""
    half = 0.5 * torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    xyz = axis * torch.sin(half)[..., None]
    w = torch.cos(half)[..., None].expand(xyz.shape[:-1] + (1,))
    return torch.cat([xyz, w], dim=-1)


def quat_from_euler_xyz(roll, pitch, yaw) -> Tensor:
    """Intrinsic xyz euler -> xyzw quaternion (isaacgym convention)."""
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    qw = cy * cr * cp + sy * sr * sp
    qx = cy * sr * cp - sy * cr * sp
    qy = cy * cr * sp + sy * sr * cp
    qz = sy * cr * cp - cy * sr * sp
    return torch.stack([qx, qy, qz, qw], dim=-1)


def get_euler_xyz(q: Tensor):
    """xyzw quaternion -> (roll, pitch, yaw), parity with isaacgym.torch_utils."""
    qx, qy, qz, qw = q.unbind(-1)
    sinr_cosp = 2.0 * (qw * qx + qy * qz)
    cosr_cosp = qw * qw - qx * qx - qy * qy + qz * qz
    roll = torch.atan2(sinr_cosp, cosr_cosp)

    sinp = 2.0 * (qw * qy - qz * qx)
    pitch = torch.where(
        torch.abs(sinp) >= 1.0,
        torch.copysign(torch.full_like(sinp, math.pi / 2.0), sinp),
        torch.asin(sinp.clamp(-1.0, 1.0)),
    )

    siny_cosp = 2.0 * (qw * qz + qx * qy)
    cosy_cosp = qw * qw + qx * qx - qy * qy - qz * qz
    yaw = torch.atan2(siny_cosp, cosy_cosp)
    two_pi = 2 * math.pi
    return (torch.remainder(roll, two_pi), torch.remainder(pitch, two_pi),
            torch.remainder(yaw, two_pi))


def normalize_angle(x: Tensor) -> Tensor:
    """Wrap angle to [-pi, pi] (isaacgym.torch_utils.normalize_angle parity)."""
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


def quat_diff_rad(a: Tensor, b: Tensor) -> Tensor:
    """Rotational distance in radians (torch_jit_utils.py:140-159 parity)."""
    mul = quat_mul(a, quat_conjugate(b))
    return 2.0 * torch.asin(
        torch.linalg.norm(mul[..., :3], dim=-1).clamp(max=1.0))


def quat_integrate(q: Tensor, omega_world: Tensor, dt) -> Tensor:
    """Integrate orientation by world angular velocity via the exp map."""
    angle = torch.linalg.norm(omega_world, dim=-1, keepdim=True)
    axis = omega_world / angle.clamp_min(1e-9)
    dq = quat_from_axis_angle(axis, (angle * dt)[..., 0])
    return quat_unit(quat_mul(dq, q))


def quat_slerp(a: Tensor, b: Tensor, t) -> Tensor:
    """Spherical interpolation from a to b at fraction t in [0,1]."""
    dot = torch.sum(a * b, dim=-1, keepdim=True)
    b = torch.where(dot < 0.0, -b, b)
    dot = torch.abs(dot).clamp(max=1.0)
    theta = torch.acos(dot)
    sin_theta = torch.sin(theta)
    # Fall back to lerp for tiny angles.
    safe = sin_theta.clamp_min(1e-9)
    lerp_a = torch.as_tensor(1.0 - t, dtype=a.dtype, device=a.device)
    lerp_b = torch.as_tensor(t, dtype=a.dtype, device=a.device)
    w_a = torch.where(sin_theta > 1e-6, torch.sin((1.0 - t) * theta) / safe,
                      lerp_a)
    w_b = torch.where(sin_theta > 1e-6, torch.sin(t * theta) / safe, lerp_b)
    return quat_unit(w_a * a + w_b * b)


# ---------------------------------------------------------------------------
# Range transforms (torch_jit_utils.py:78-134 parity)
# ---------------------------------------------------------------------------

def scale_transform(x, lower, upper):
    """Map [lower, upper] -> [-1, 1]."""
    offset = (lower + upper) * 0.5
    return 2.0 * (x - offset) / (upper - lower)


def unscale_transform(x, lower, upper):
    """Map [-1, 1] -> [lower, upper]."""
    offset = (lower + upper) * 0.5
    return x * (upper - lower) * 0.5 + offset


def saturate(x, lower, upper):
    return torch.clamp(x, lower, upper)


def local_to_world_space(pos_offset_local, pose_pos, pose_quat):
    """Transform a local point into world space (torch_jit_utils.py:162-181)."""
    return pose_pos + quat_rotate(pose_quat, pos_offset_local)
