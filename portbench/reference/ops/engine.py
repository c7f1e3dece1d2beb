"""The physics step: FK -> actuation -> contact -> implicit solve -> integrate.

Port of `bez_isaacgym_tpu/ops/engine.py` in plain batched PyTorch.  This is
the CPU path of the port and the plain version that the CUDA substep kernel
(`ops/substep.py`) is held against.

Numerical scheme (dense f32):
- generalized coords: base pos + xyzw quat + 18 joint angles; velocities
  u = [v_base_origin(world), w_base(world), qd].
- Stable-PD joint servos (implicit spring+damper via the mass-matrix
  diagonal) reproduce PhysX's implicit position drives (Kp=100/Kd=7.5,
  effort clamp 2.5: kick_env.py:322-329).
- contact damping terms are folded into the LHS (one-Newton-step implicit
  Euler) via per-body 6x6 moment matrices.
- semi-implicit Euler integration; base orientation via quaternion exp map.

Every tensor carries a leading env axis (any leading dims work, including
none); params broadcast against it, so they may be per-env or shared.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.models.bez import (BALL_INERTIA, BALL_MASS,
                                               BALL_RADIUS,
                                               BALL_ROLLING_FRICTION)
from portbench.reference.models.robot import DynParams, RobotModel
from portbench.reference.ops import contact as ct
from portbench.reference.ops import dynamics as dyn
from portbench.reference.ops import kinematics as kin
from portbench.reference.ops.linalg import solve_spd_ordered
from portbench.reference.ops.quat import cross, quat_integrate

Tensor = torch.Tensor


class PhysicsState(NamedTuple):
    """Simulation state; every field has a leading env axis."""

    q: Tensor            # (..., nq)
    qd: Tensor           # (..., nq)
    base_pos: Tensor     # (..., 3)
    base_quat: Tensor    # (..., 4) xyzw
    base_u: Tensor       # (..., 6) [v_origin, w] world
    ball_pos: Tensor     # (..., 3)
    ball_quat: Tensor    # (..., 4)
    ball_vel: Tensor     # (..., 3)
    ball_ang: Tensor     # (..., 3)
    # Diagnostics from the last substep (read by sensors):
    sensor_normal: Tensor       # (..., 8) foot sensor normal forces
    body_contact_force: Tensor  # (..., nb, 3) net contact force per body


@dataclass(frozen=True)
class SceneConfig:
    """Static scene/integrator configuration."""

    dt: float = 1.0 / 60.0        # control period (bez_kick.yaml:129)
    substeps: int = 4             # internal steps per control period
    has_ball: bool = True
    ball_radius: float = BALL_RADIUS
    ball_mass: float = BALL_MASS
    ball_inertia: float = BALL_INERTIA
    ball_rolling_friction: float = BALL_ROLLING_FRICTION
    max_joint_vel: float = 2.0 * math.pi  # MX-28 cap (kick_env.py:102,327)
    # Stability guards for extreme impacts; normal locomotion stays far
    # below these caps.
    max_base_lin_vel: float = 20.0        # m/s
    max_base_ang_vel: float = 50.0        # rad/s
    max_ball_vel: float = 30.0            # m/s (kicked/shot ball)
    coeffs: ct.ContactCoeffs = ct.ContactCoeffs()
    friction_vel_scale: float = 0.05


class SubstepAux(NamedTuple):
    """Carries everything _integrate needs besides the solved udot."""

    ball_F: Tensor
    ball_N: Tensor
    sensor_normal: Tensor
    body_cf: Tensor
    u: Tensor


def default_state(model: RobotModel, cfg: SceneConfig, q: Tensor, base_pos,
                  base_quat, ball_pos=(0.175, 0.0, 0.08)) -> PhysicsState:
    """State at rest with joint angles q (..., nq); the other poses broadcast
    to q's leading dims."""
    q = torch.as_tensor(q, dtype=torch.float32)
    batch = q.shape[:-1]

    def full(x, d):
        t = torch.as_tensor(x, dtype=q.dtype, device=q.device)
        return t.expand(batch + (d,)).clone()

    def zeros(*shape):
        return torch.zeros(batch + shape, dtype=q.dtype, device=q.device)

    return PhysicsState(
        q=q.clone(), qd=zeros(model.nq),
        base_pos=full(base_pos, 3), base_quat=full(base_quat, 4),
        base_u=zeros(6), ball_pos=full(ball_pos, 3),
        ball_quat=full((0.0, 0.0, 0.0, 1.0), 4),
        ball_vel=zeros(3), ball_ang=zeros(3),
        sensor_normal=zeros(8), body_contact_force=zeros(model.nb, 3))


def _contact_damping_W(model: RobotModel, cfg: SceneConfig, frames, vel,
                       mu) -> Tensor:
    """Per-body implicit-contact damping matrices W_b (..., nb, 6, 6).

    W_b = sum_{c in b} M_c^T D_c M_c with M_c = [I3, -skew(r_c)] and
    D_c = diag(d_t, d_t, d_n), accumulated via 16 scalar moments per point
    (one segment sum) and folded into the spatial inertia G_b.
    """
    like = frames.pos
    cp = kin.model_const(model, "cpoint_pos", like)
    cb = kin.model_const(model, "cpoint_body", like).long()
    Rc = frames.rot[..., cb, :, :]
    p_c = frames.pos[..., cb, :] + torch.einsum("...cij,cj->...ci", Rc, cp)
    r = p_c - frames.com[..., cb, :]
    pen = -p_c[..., 2]
    active = (pen > 0.0).to(like.dtype)
    fn_est = (cfg.coeffs.kn * pen).clamp_min(0.0) * active
    v_c = vel.v_com[..., cb, :] + cross(vel.w[..., cb, :], r)
    vt_norm = torch.sqrt(v_c[..., 0] ** 2 + v_c[..., 1] ** 2
                         + cfg.coeffs.vt_eps ** 2)
    mu = torch.as_tensor(mu, dtype=like.dtype, device=like.device)
    d_t = mu[..., None] * fn_est / vt_norm
    d_n = cfg.coeffs.cn * active
    g = d_n - d_t

    x, y, z = r.unbind(-1)
    cols = torch.stack([
        d_t,
        d_t * x, d_t * y, d_t * z,
        d_t * x * x, d_t * y * y, d_t * z * z,
        d_t * x * y, d_t * x * z, d_t * y * z,
        g,
        g * x, g * y,
        g * x * x, g * y * y, g * x * y,
    ], dim=-1)                                            # (..., nc, 16)
    m = ct._segment_sum(cols, cb, model.nb)               # (..., nb, 16)
    (s_dt, sx, sy, sz, sxx, syy, szz, sxy, sxz, syz,
     s_g, s_gx, s_gy, s_gxx, s_gyy, s_gxy) = m.unbind(-1)
    zero = torch.zeros_like(s_dt)

    def mat(rows):
        return torch.stack([torch.stack(r_, dim=-1) for r_ in rows], dim=-2)

    A = mat([[s_dt, zero, zero], [zero, s_dt, zero], [zero, zero, s_dt + s_g]])
    B = mat([[zero, sz, -sy], [-sz, zero, sx], [sy + s_gy, -(sx + s_gx), zero]])
    E00 = szz + syy + s_gyy
    E01 = -(sxy + s_gxy)
    E02 = -sxz
    E11 = szz + sxx + s_gxx
    E12 = -syz
    E22 = sxx + syy
    E = mat([[E00, E01, E02], [E01, E11, E12], [E02, E12, E22]])
    return torch.cat([torch.cat([A, B], dim=-1),
                      torch.cat([B.transpose(-1, -2), E], dim=-1)], dim=-2)


def _prepare(model: RobotModel, cfg: SceneConfig, mask, params: DynParams,
             state: PhysicsState, targets: Tensor, h: float):
    """Everything up to the linear solve: returns (H_eff, tau, aux)."""
    f32 = state.q.dtype
    dev = state.q.device

    def t(x):
        return torch.as_tensor(x, dtype=f32, device=dev)

    frames = kin.forward_kinematics(model, state.q, state.base_pos,
                                    state.base_quat)
    J_lin, J_ang = kin.com_jacobians(model, frames, mask)
    u = torch.cat([state.base_u, state.qd], dim=-1)
    vel = dyn.body_velocities(J_lin, J_ang, u)
    m, I_w = dyn.world_inertias(model, frames, t(params.mass_scale))
    alpha0, a0 = dyn.bias_accelerations(model, frames, vel, state.qd)

    # --- Stable-PD actuation (implicit spring-damper, explicit clamp) ------
    kp, kd, effort = t(params.kp), t(params.kd), t(params.effort)
    tau_pd = kp * (targets - state.q) - (h * kp + kd) * state.qd
    tau_pd = _clip(tau_pd, -effort, effort)
    # Regularized Coulomb joint friction, implicit viscous form.
    c_fric = t(params.joint_friction) / (torch.abs(state.qd)
                                         + cfg.friction_vel_scale)
    tau_joint = tau_pd - c_fric * state.qd
    implicit_joint = h * (h * kp + kd + c_fric)

    # --- contacts ----------------------------------------------------------
    mu = t(params.ground_friction)
    wr = ct.robot_plane_contacts(model, frames, vel, mu, cfg.coeffs)
    sensor_normal = wr.sensor_normal
    body_cf = wr.body_force
    F_b, N_b = wr.F, wr.N
    grav = t(params.gravity)

    if cfg.has_ball:
        wr2, bf_robot = ct.ball_robot_contacts(
            model, frames, vel, state.ball_pos, state.ball_vel,
            state.ball_ang, cfg.ball_radius, mu, cfg.coeffs)
        F_b = F_b + wr2.F
        N_b = N_b + wr2.N
        body_cf = body_cf + wr2.body_force
        bf_plane = ct.ball_plane_contact(
            state.ball_pos, state.ball_vel, state.ball_ang, cfg.ball_radius,
            mu, cfg.ball_rolling_friction, cfg.coeffs)
        ball_F = bf_robot.F + bf_plane.F + cfg.ball_mass * grav
        ball_N = bf_robot.N + bf_plane.N
    else:
        ball_F = torch.zeros_like(state.ball_pos)
        ball_N = torch.zeros_like(state.ball_pos)

    # --- one fused LHS/RHS assembly ----------------------------------------
    # G_b = blockdiag(m_b I3, I_w_b) + h * W_b; H_eff = sum_b J6_b^T G_b J6_b.
    W = _contact_damping_W(model, cfg, frames, vel, mu)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    M_spatial = torch.cat([
        torch.cat([m[..., None, None] * eye3, torch.zeros_like(I_w)], dim=-1),
        torch.cat([torch.zeros_like(I_w), I_w], dim=-1),
    ], dim=-2)                                            # (..., nb, 6, 6)
    G = M_spatial + h * W
    J6 = torch.cat([J_lin, J_ang], dim=-2)                # (..., nb, 6, nv)
    T = torch.einsum("...bac,...bcw->...baw", G, J6)
    H_eff = torch.einsum("...bav,...baw->...vw", J6, T)

    arm = t(params.armature) + implicit_joint
    diag_extra = torch.cat([torch.zeros(arm.shape[:-1] + (6,), dtype=f32,
                                        device=dev), arm], dim=-1)
    H_eff = H_eff + torch.diag_embed(diag_extra)

    # RHS: tau = S tau_joint + J6^T [F - m(a0 - g); N - I alpha0 - w x I w].
    f_net = F_b - m[..., None] * (a0 - grav[..., None, :])
    Iw_w = torch.einsum("...bij,...bj->...bi", I_w, vel.w)
    n_net = N_b - torch.einsum("...bij,...bj->...bi", I_w, alpha0) \
        - cross(vel.w, Iw_w)
    wrench6 = torch.cat([f_net, n_net], dim=-1)           # (..., nb, 6)
    tau = torch.cat([torch.zeros(tau_joint.shape[:-1] + (6,), dtype=f32,
                                 device=dev), tau_joint], dim=-1)
    tau = tau + torch.einsum("...bav,...ba->...v", J6, wrench6)
    aux = SubstepAux(ball_F=ball_F, ball_N=ball_N,
                     sensor_normal=sensor_normal, body_cf=body_cf, u=u)
    return H_eff, tau, aux


def _clip(x: Tensor, lo, hi) -> Tensor:
    """jnp.clip semantics: min(max(x, lo), hi), bounds broadcast."""
    return torch.minimum(
        torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype, device=x.device)),
        torch.as_tensor(hi, dtype=x.dtype, device=x.device))


def _integrate(model: RobotModel, cfg: SceneConfig, params: DynParams,
               state: PhysicsState, udot: Tensor, aux: SubstepAux,
               h: float) -> PhysicsState:
    """Semi-implicit Euler update from the solved accelerations."""
    u_new = aux.u + h * udot
    qd_new = _clip(u_new[..., 6:], -cfg.max_joint_vel, cfg.max_joint_vel)
    q_new = state.q + h * qd_new
    # Joint limits come from params when present (per-env DR of the DOF
    # lower/upper props, bez_kick.yaml:205-214), else the model's.
    like = state.q
    lower = torch.as_tensor(params.dof_lower if params.dof_lower is not None
                            else model.dof_lower, dtype=like.dtype,
                            device=like.device)
    upper = torch.as_tensor(params.dof_upper if params.dof_upper is not None
                            else model.dof_upper, dtype=like.dtype,
                            device=like.device)
    q_clamped = _clip(q_new, lower, upper)
    at_limit = (q_new < lower) | (q_new > upper)
    qd_new = torch.where(at_limit, torch.zeros_like(qd_new), qd_new)

    base_u_new = torch.cat([
        _clip(u_new[..., 0:3], -cfg.max_base_lin_vel, cfg.max_base_lin_vel),
        _clip(u_new[..., 3:6], -cfg.max_base_ang_vel, cfg.max_base_ang_vel)],
        dim=-1)
    base_pos_new = state.base_pos + h * base_u_new[..., :3]
    base_quat_new = quat_integrate(state.base_quat, base_u_new[..., 3:6], h)

    if cfg.has_ball:
        ball_vel = _clip(state.ball_vel + h * aux.ball_F / cfg.ball_mass,
                         -cfg.max_ball_vel, cfg.max_ball_vel)
        ball_ang = state.ball_ang + h * aux.ball_N / cfg.ball_inertia
        ball_pos = state.ball_pos + h * ball_vel
        ball_quat = quat_integrate(state.ball_quat, ball_ang, h)
    else:
        ball_vel, ball_ang = state.ball_vel, state.ball_ang
        ball_pos, ball_quat = state.ball_pos, state.ball_quat

    return PhysicsState(
        q=q_clamped, qd=qd_new, base_pos=base_pos_new,
        base_quat=base_quat_new, base_u=base_u_new,
        ball_pos=ball_pos, ball_quat=ball_quat,
        ball_vel=ball_vel, ball_ang=ball_ang,
        sensor_normal=aux.sensor_normal, body_contact_force=aux.body_cf)


def joints_first_order(model: RobotModel) -> np.ndarray:
    """Elimination order: joint DOFs before the base (the f32-stable order
    for articulated-body mass matrices, see ops/linalg.py)."""
    nv = 6 + model.nq
    return np.concatenate([np.arange(6, nv), np.arange(6)])


def substep(model: RobotModel, cfg: SceneConfig, mask, params: DynParams,
            state: PhysicsState, targets: Tensor, h: float) -> PhysicsState:
    """One substep of length h: prepare, joints-first solve, integrate."""
    H_eff, tau, aux = _prepare(model, cfg, mask, params, state, targets, h)
    udot = solve_spd_ordered(H_eff, tau, joints_first_order(model))
    return _integrate(model, cfg, params, state, udot, aux, h)


def make_batched_step_fn(model: RobotModel, cfg: SceneConfig):
    """Batched step: step_fn(params, states, targets) -> states.

    states/targets carry a leading env axis; params may too (per-env domain
    randomization) or broadcast.  Advances one control period (cfg.dt) with
    cfg.substeps internal steps.
    """
    mask = kin.ancestor_mask(model)
    h = cfg.dt / cfg.substeps

    def step_fn(params: DynParams, states: PhysicsState,
                targets: Tensor) -> PhysicsState:
        for _ in range(cfg.substeps):
            states = substep(model, cfg, mask, params, states, targets, h)
        return states

    return step_fn


def make_step_fn(model: RobotModel, cfg: SceneConfig):
    """Single-env step_fn(params, state, targets) -> state.

    The batched functions take any leading dims, including none, so this is
    the batched step applied to one env's unbatched tensors.
    """
    return make_batched_step_fn(model, cfg)
