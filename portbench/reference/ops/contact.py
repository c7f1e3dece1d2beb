"""Compliant contact model: point-plane, sphere-plane, sphere-box.

Port of `bez_isaacgym_tpu/ops/contact.py`: a smooth penalty model with
branch-free `where` masking over a static set of candidate contacts (box
corners from the URDF collision geometry, the ball sphere).  Normal:
spring-damper.  Friction: regularized Coulomb.  Also produces the contact
diagnostics the reference reads back from PhysX (kick_env.py:146,187-196):
per-foot-sensor normal forces and per-body net contact forces.

Tensors carry any leading batch dimensions; `mu` has the batch shape (or is
a scalar).  `segment_sum` over bodies becomes a one-hot product.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.models.robot import RobotModel
from portbench.reference.ops.dynamics import BodyVel
from portbench.reference.ops.kinematics import BodyFrames, model_const
from portbench.reference.ops.quat import cross

Tensor = torch.Tensor


class ContactCoeffs(NamedTuple):
    """Static penalty coefficients (set once per scene)."""

    kn: float = 6000.0      # normal spring [N/m]
    cn: float = 60.0        # normal damping [N*s/m]
    vt_eps: float = 0.02    # tangential velocity regularization [m/s]
    ball_kn: float = 3000.0
    ball_cn: float = 8.0


class Wrenches(NamedTuple):
    F: Tensor              # (..., nb, 3) world force at COM per body
    N: Tensor              # (..., nb, 3) world torque about COM per body
    sensor_normal: Tensor  # (..., 8) summed normal force per foot sensor slot
    body_force: Tensor     # (..., nb, 3) net contact force per body (world)


def _friction_dir(vt: Tensor, eps: float) -> Tensor:
    """Smooth unit vector along tangential velocity.

    sqrt(|vt|^2 + eps^2) (not norm+eps): the form is C^inf, so no NaN
    tangent at vt=0 leaks into a linearization of the step."""
    ssq = torch.sum(vt * vt, dim=-1, keepdim=True)
    return vt / torch.sqrt(ssq + eps * eps)


def _segment_sum(x: Tensor, seg: Tensor, n: int) -> Tensor:
    """Sum x (..., k, d) into n segments along dim -2 by seg (k,).

    A product with the (n, k) one-hot matrix of seg: it sums in a fixed
    order on every device (CUDA's `index_add` adds atomically, in no fixed
    order, so two runs of the plain engine on the card could differ in the
    last bit), and it holds under `torch.func.vmap` over tangents, where an
    in-place add of a batched x into unbatched zeros raises."""
    onehot = (seg[None, :] == torch.arange(n, device=x.device)[:, None])
    return torch.einsum("nk,...kd->...nd", onehot.to(x.dtype), x)


def robot_plane_contacts(model: RobotModel, frames: BodyFrames, vel: BodyVel,
                         mu: Tensor, coeffs: ContactCoeffs) -> Wrenches:
    """Ground (z=0 plane) contact forces for all candidate points."""
    cp = model_const(model, "cpoint_pos", frames.pos)              # (nc,3)
    cb = model_const(model, "cpoint_body", frames.pos).long()      # (nc,)
    R = frames.rot[..., cb, :, :]                                  # (...,nc,3,3)
    p = frames.pos[..., cb, :] + torch.einsum("...cij,cj->...ci", R, cp)
    r = p - frames.com[..., cb, :]
    v = vel.v_com[..., cb, :] + cross(vel.w[..., cb, :], r)

    pen = -p[..., 2]
    vn = v[..., 2]
    fn = torch.where(pen > 0.0, coeffs.kn * pen - coeffs.cn * vn,
                     torch.zeros_like(pen)).clamp_min(0.0)

    vt = torch.cat([v[..., :2], torch.zeros_like(v[..., 2:])], dim=-1)
    mu = torch.as_tensor(mu, dtype=fn.dtype, device=fn.device)
    ft = -mu[..., None, None] * fn[..., None] * _friction_dir(vt, coeffs.vt_eps)
    f = torch.cat([ft[..., :2], fn[..., None]], dim=-1)           # (...,nc,3)

    F = _segment_sum(f, cb, model.nb)
    N = _segment_sum(cross(r, f), cb, model.nb)

    # Foot sensors: sum normal force into slots 0..7 (slot -1 -> bucket 8).
    sens = model_const(model, "cpoint_sensor", frames.pos).long()
    slots = torch.where(sens >= 0, sens, torch.full_like(sens, 8))
    sensor = _segment_sum(fn[..., None], slots, 9)[..., :8, 0]
    return Wrenches(F=F, N=N, sensor_normal=sensor, body_force=F)


class BallForces(NamedTuple):
    F: Tensor  # (..., 3) world force on ball
    N: Tensor  # (..., 3) world torque on ball about its center


def ball_plane_contact(ball_pos: Tensor, ball_vel: Tensor, ball_ang: Tensor,
                       radius: float, mu: Tensor, rolling_friction: float,
                       coeffs: ContactCoeffs) -> BallForces:
    """Sphere vs ground plane, with Coulomb + rolling friction
    (ball.urdf contact block: lateral 0.99, rolling/spinning 0.01)."""
    pen = radius - ball_pos[..., 2]
    offset = torch.tensor([0.0, 0.0, -radius], dtype=ball_pos.dtype,
                          device=ball_pos.device)
    v = ball_vel + cross(ball_ang, offset)
    fn = torch.where(pen > 0.0, coeffs.ball_kn * pen - coeffs.ball_cn * v[..., 2],
                     torch.zeros_like(pen)).clamp_min(0.0)
    vt = torch.cat([v[..., :2], torch.zeros_like(v[..., 2:])], dim=-1)
    mu = torch.as_tensor(mu, dtype=fn.dtype, device=fn.device)
    ft = -(mu * fn)[..., None] * _friction_dir(vt, coeffs.vt_eps)
    f = torch.cat([ft[..., :2], fn[..., None]], dim=-1)
    torque = cross(offset, f)
    # Rolling resistance opposing spin (smooth at ball_ang=0).
    w_norm = torch.sqrt(torch.sum(ball_ang * ball_ang, dim=-1, keepdim=True)
                        + 1e-12)
    torque = torque - rolling_friction * (fn * radius)[..., None] \
        * ball_ang / w_norm
    return BallForces(F=f, N=torque)


def ball_robot_contacts(model: RobotModel, frames: BodyFrames, vel: BodyVel,
                        ball_pos: Tensor, ball_vel: Tensor, ball_ang: Tensor,
                        radius: float, mu: Tensor,
                        coeffs: ContactCoeffs) -> tuple[Wrenches, BallForces]:
    """Ball sphere vs every robot collision box (kick/goalie interaction)."""
    like = frames.pos
    bb = model_const(model, "box_body", like).long()               # (nbx,)
    Rb = frames.rot[..., bb, :, :]
    box_c = frames.pos[..., bb, :] + torch.einsum(
        "...kij,kj->...ki", Rb, model_const(model, "box_pos", like))
    Rbox = torch.einsum("...kij,kjl->...kil", Rb,
                        model_const(model, "box_rot", like))
    half = model_const(model, "box_half", like)

    # Closest point on each box to the ball center.
    bp = ball_pos[..., None, :]
    local = torch.einsum("...kji,...kj->...ki", Rbox, bp - box_c)
    clamped = torch.maximum(torch.minimum(local, half), -half)
    closest = box_c + torch.einsum("...kij,...kj->...ki", Rbox, clamped)
    delta = bp - closest
    # Smooth at delta=0 (ball center exactly on a box face/inside).
    dist = torch.sqrt(torch.sum(delta * delta, dim=-1) + 1e-12)
    # If the center is inside the box, dist ~ 0; push up as a safe fallback.
    up = torch.tensor([0.0, 0.0, 1.0], dtype=like.dtype, device=like.device)
    n = torch.where(dist[..., None] > 1e-6, delta / (dist[..., None] + 1e-9),
                    up)
    pen = radius - dist

    v_ball_pt = ball_vel[..., None, :] + cross(ball_ang[..., None, :],
                                                closest - bp)
    r_body = closest - frames.com[..., bb, :]
    v_body_pt = vel.v_com[..., bb, :] + cross(vel.w[..., bb, :], r_body)
    rel = v_ball_pt - v_body_pt
    vn = torch.sum(rel * n, dim=-1)

    fn = torch.where(pen > 0.0, coeffs.ball_kn * pen - coeffs.ball_cn * vn,
                     torch.zeros_like(pen)).clamp_min(0.0)
    vt = rel - vn[..., None] * n
    mu = torch.as_tensor(mu, dtype=fn.dtype, device=fn.device)
    f_ball = fn[..., None] * n - (mu[..., None] * fn)[..., None] \
        * _friction_dir(vt, coeffs.vt_eps)

    F_ball = torch.sum(f_ball, dim=-2)
    N_ball = torch.sum(cross(closest - bp, f_ball), dim=-2)

    F = _segment_sum(-f_ball, bb, model.nb)
    N = _segment_sum(cross(r_body, -f_ball), bb, model.nb)
    wr = Wrenches(F=F, N=N,
                  sensor_normal=torch.zeros(F.shape[:-2] + (8,),
                                            dtype=F.dtype, device=F.device),
                  body_force=F)
    return wr, BallForces(F=F_ball, N=N_ball)
