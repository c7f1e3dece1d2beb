"""Articulated rigid-body dynamics: mass matrix + bias forces (world frame).

Port of `bez_isaacgym_tpu/ops/dynamics.py`.  Formulation: projected
Newton-Euler ("Jacobian form" of CRBA/RNEA).  With generalized velocity
u = [v_base_origin, w_base, qd] (nv = 6 + nq):

    H(q)  = sum_i  J_lin_i^T m_i J_lin_i  +  J_ang_i^T I_i J_ang_i
    bias  = sum_i  J_lin_i^T m_i (a0_i - g) + J_ang_i^T (I_i alpha0_i + w_i x I_i w_i)

where (a0, alpha0) are the velocity-product accelerations (qdd = 0), computed
by one forward recursion over the tree.  Tensors carry any leading batch
dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.models.robot import RobotModel
from portbench.reference.ops.kinematics import BodyFrames, model_const
from portbench.reference.ops.quat import cross

Tensor = torch.Tensor


class BodyVel(NamedTuple):
    w: Tensor       # (..., nb, 3) world angular velocity
    v_com: Tensor   # (..., nb, 3) world COM linear velocity


def body_velocities(J_lin: Tensor, J_ang: Tensor, u: Tensor) -> BodyVel:
    return BodyVel(w=torch.einsum("...biv,...v->...bi", J_ang, u),
                   v_com=torch.einsum("...biv,...v->...bi", J_lin, u))


def world_inertias(model: RobotModel, frames: BodyFrames,
                   mass_scale: Tensor) -> tuple[Tensor, Tensor]:
    """Per-body mass and world-frame rotational inertia about COM.

    mass_scale (..., nb) implements rigid-body mass domain randomization;
    inertia scales with mass.
    """
    rot = frames.rot
    m = model_const(model, "mass", rot) * mass_scale
    I_body = model_const(model, "inertia", rot) * mass_scale[..., None, None]
    I_w = torch.einsum("...bij,...bjk,...blk->...bil", rot, I_body, rot)
    return m.expand(I_w.shape[:-2]), I_w


def bias_accelerations(model: RobotModel, frames: BodyFrames, vel: BodyVel,
                       qd: Tensor) -> tuple[Tensor, Tensor]:
    """Velocity-product accelerations (qdd = 0): returns (alpha0, a_com0)."""
    w = vel.w
    alpha = [torch.zeros_like(w[..., 0, :])]
    r0 = frames.com[..., 0, :] - frames.pos[..., 0, :]
    a_com = [cross(w[..., 0, :], cross(w[..., 0, :], r0))]
    for b in range(1, model.nb):
        p = int(model.parent[b])
        d = b - 1
        aj = frames.axis_w[..., d, :]
        r_pa = frames.anchor[..., d, :] - frames.com[..., p, :]
        r_ac = frames.com[..., b, :] - frames.anchor[..., d, :]
        wp, wb = w[..., p, :], w[..., b, :]
        alpha_b = alpha[p] + cross(wp, aj * qd[..., d:d + 1])
        a_anchor = a_com[p] + cross(alpha[p], r_pa) \
            + cross(wp, cross(wp, r_pa))
        a_com_b = a_anchor + cross(alpha_b, r_ac) \
            + cross(wb, cross(wb, r_ac))
        alpha.append(alpha_b)
        a_com.append(a_com_b)
    return torch.stack(alpha, dim=-2), torch.stack(a_com, dim=-2)


def mass_matrix(J_lin: Tensor, J_ang: Tensor, m: Tensor, I_w: Tensor,
                armature: Tensor) -> Tensor:
    """(..., nv, nv) joint-space inertia matrix with reflected rotor inertia."""
    H = torch.einsum("...b,...biv,...biw->...vw", m, J_lin, J_lin)
    H = H + torch.einsum("...biv,...bij,...bjw->...vw", J_ang, I_w, J_ang)
    diag = torch.cat([torch.zeros(armature.shape[:-1] + (6,),
                                  dtype=H.dtype, device=H.device),
                      armature.expand(H.shape[:-2] + armature.shape[-1:])],
                     dim=-1)
    return H + torch.diag_embed(diag)


def bias_force(J_lin: Tensor, J_ang: Tensor, m: Tensor, I_w: Tensor,
               vel: BodyVel, alpha0: Tensor, a_com0: Tensor,
               gravity: Tensor) -> Tensor:
    """(..., nv) generalized bias (Coriolis + gravity), to be subtracted."""
    f = m[..., None] * (a_com0 - gravity[..., None, :])
    n = torch.einsum("...bij,...bj->...bi", I_w, alpha0) \
        + cross(vel.w, torch.einsum("...bij,...bj->...bi", I_w, vel.w))
    return body_wrench_to_generalized(J_lin, J_ang, f, n)


def body_wrench_to_generalized(J_lin: Tensor, J_ang: Tensor, F: Tensor,
                               N: Tensor) -> Tensor:
    """Map per-body world wrenches (force at COM F, torque N) to (..., nv)."""
    return torch.einsum("...biv,...bi->...v", J_lin, F) \
        + torch.einsum("...biv,...bi->...v", J_ang, N)


def pd_torque(q: Tensor, qd: Tensor, targets: Tensor, kp: Tensor, kd: Tensor,
              effort: Tensor, joint_friction: Tensor,
              friction_vel_scale: float = 0.05) -> Tensor:
    """PD position servo with torque clamp + smooth Coulomb joint friction
    (reference actuator config: Kp=100, Kd=7.5, effort clamp 2.5, friction
    0.1, kick_env.py:322-329)."""
    tau = torch.clamp(kp * (targets - q) - kd * qd, -effort, effort)
    return tau - joint_friction * torch.tanh(qd / friction_vel_scale)
