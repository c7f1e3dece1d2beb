"""Forward kinematics and world-frame Jacobians for the articulated body.

Port of `bez_isaacgym_tpu/ops/kinematics.py`.  Every function takes tensors
with any leading batch dimensions (the env axis, written out where the JAX
package used `vmap`); the body loop runs over the static tree (nb = 19 for
Bez).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.models.robot import RobotModel
from portbench.reference.ops.quat import cross, quat_to_matrix

Tensor = torch.Tensor


def model_const(model: RobotModel, name: str, like: Tensor) -> Tensor:
    """A RobotModel array as a tensor on `like`'s device and dtype.

    Cached on the model object, so each array crosses to a device once.
    """
    cache = model.__dict__.setdefault("_tensor_cache", {})
    key = (name, like.device, like.dtype)
    t = cache.get(key)
    if t is None:
        t = torch.as_tensor(np.asarray(getattr(model, name)),
                            device=like.device)
        if t.is_floating_point():
            t = t.to(like.dtype)
        cache[key] = t
    return t


class BodyFrames(NamedTuple):
    """World-frame kinematic quantities per movable body."""

    rot: Tensor      # (..., nb, 3, 3) body->world rotation
    pos: Tensor      # (..., nb, 3) body frame origin (= joint anchor, i>0)
    com: Tensor      # (..., nb, 3) world COM position
    axis_w: Tensor   # (..., nq, 3) world joint axes
    anchor: Tensor   # (..., nq, 3) world joint anchor points


def _axis_angle_matrix(axis: Tensor, angle: Tensor) -> Tensor:
    """Rotation about a static unit axis by a batched angle (Rodrigues)."""
    zero = torch.zeros((), dtype=axis.dtype, device=axis.device)
    K = torch.stack([
        torch.stack([zero, -axis[2], axis[1]]),
        torch.stack([axis[2], zero, -axis[0]]),
        torch.stack([-axis[1], axis[0], zero]),
    ])
    s = torch.sin(angle)[..., None, None]
    c = torch.cos(angle)[..., None, None]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return eye + s * K + (1.0 - c) * (K @ K)


def forward_kinematics(model: RobotModel, q: Tensor, base_pos: Tensor,
                       base_quat: Tensor) -> BodyFrames:
    """World poses of all movable bodies.

    q: (..., nq) joint angles; base_pos (..., 3); base_quat (..., 4) xyzw.
    """
    tree_pos = model_const(model, "tree_pos", q)
    tree_rot = model_const(model, "tree_rot", q)
    axis = model_const(model, "axis", q)
    rots = [quat_to_matrix(base_quat)]
    poss = [base_pos]
    axes, anchors = [], []
    for b in range(1, model.nb):
        p = int(model.parent[b])
        d = b - 1
        Rp, pp = rots[p], poss[p]
        anchor = pp + Rp @ tree_pos[b]
        R_pre = Rp @ tree_rot[b]
        rots.append(R_pre @ _axis_angle_matrix(axis[d], q[..., d]))
        poss.append(anchor)
        axes.append(R_pre @ axis[d])
        anchors.append(anchor)
    rot = torch.stack(rots, dim=-3)
    pos = torch.stack(poss, dim=-2)
    com = pos + torch.einsum("...bij,bj->...bi", rot,
                             model_const(model, "com", q))
    return BodyFrames(rot=rot, pos=pos, com=com,
                      axis_w=torch.stack(axes, dim=-2),
                      anchor=torch.stack(anchors, dim=-2))


def ancestor_mask(model: RobotModel) -> np.ndarray:
    """(nb, nq) static bool mask: dof j moves body i."""
    mask = np.zeros((model.nb, model.nq), dtype=bool)
    for b in range(1, model.nb):
        mask[b] = mask[model.parent[b]]
        mask[b, b - 1] = True
    return mask


def _skew(v: Tensor) -> Tensor:
    """(...,3) -> (...,3,3) cross-product matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def com_jacobians(model: RobotModel, frames: BodyFrames,
                  mask: np.ndarray) -> tuple[Tensor, Tensor]:
    """World-frame COM Jacobians for every body.

    Generalized velocity u = [v_base_origin(3), w_base(3), qd(nq)], nv = 6+nq.
    Returns (J_lin, J_ang) with shape (..., nb, 3, nv) such that
    v_com_i = J_lin[i] @ u and w_i = J_ang[i] @ u.
    """
    nb = model.nb
    com = frames.com
    batch = com.shape[:-2]
    m = torch.as_tensor(mask, dtype=com.dtype, device=com.device)  # (nb,nq)
    eye = torch.eye(3, dtype=com.dtype, device=com.device).expand(
        batch + (nb, 3, 3))

    # Angular: base w columns = I; joint columns = axis * mask.
    zero3 = torch.zeros(batch + (nb, 3, 3), dtype=com.dtype,
                        device=com.device)
    ang_joints = torch.einsum("...da,bd->...bad", frames.axis_w, m)
    J_ang = torch.cat([zero3, eye, ang_joints], dim=-1)

    # Linear: v_com = v0 + w x (c - p0) + sum_j qd_j * a_j x (c - p_j).
    r0 = com - frames.pos[..., 0:1, :]                           # (...,nb,3)
    arm = com[..., :, None, :] - frames.anchor[..., None, :, :]  # (...,nb,nq,3)
    lever = cross(frames.axis_w[..., None, :, :], arm)
    lin_joints = torch.einsum("...bda,bd->...bad", lever, m)
    J_lin = torch.cat([eye, -_skew(r0), lin_joints], dim=-1)
    return J_lin, J_ang


def point_jacobian(J_lin_b: Tensor, J_ang_b: Tensor, point: Tensor,
                   com: Tensor) -> Tensor:
    """Jacobian of a world point rigidly attached to a body.

    v_p = v_com + w x (p - com)  =>  J_p = J_lin - skew(p - com) @ J_ang.
    Accepts broadcasting leading dims on point.
    """
    return J_lin_b - _skew(point - com) @ J_ang_b
