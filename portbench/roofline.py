"""The substep kernel's least time on the card: a frozen copy of the port's
count (`ops/substep.py` at commit d76e677: `bytes_per_env`, `contact_activity`,
`flop_terms` and the `Bound` arithmetic), over the reference's robot model.

A launch moves every input row once and writes every output row once, float32
(`bytes_per_env`), and needs the operations `flop_terms` counts for the
contacts its data activates.  Its least time is the larger of bytes over the
card's memory rate and operations over its fp32 rate (`portbench/peaks.py`).
Later changes to the port do not move this yardstick.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.models.robot import RobotModel
from portbench.reference.ops import kinematics as kin
from portbench.reference.ops.engine import SceneConfig

Tensor = torch.Tensor


def state_rows(nq: int) -> int:
    return 2 * nq + 26


def param_rows(nq: int, nb: int) -> int:
    return 8 * nq + nb + 4


def out_rows(nq: int, nb: int) -> int:
    return 2 * nq + 34 + 3 * nb


# The ball's state rows: ball_pos, ball_quat, ball_vel, ball_ang.
BALL_ROWS = 13


def bytes_per_env(model: RobotModel, has_ball: bool = True) -> int:
    """Bytes one launch must move per env: every input row read once and
    every output row written once, float32.  Without a ball the substep
    needs none of the ball's rows, in or out."""
    nq, nb = model.nq, model.nb
    rows = state_rows(nq) + param_rows(nq, nb) + out_rows(nq, nb)
    return 4 * (rows - (0 if has_ball else 2 * BALL_ROWS))


class ContactActivity(NamedTuple):
    """How many of the batch's envs have each contact penetrating
    (pen > 0, the kernel's `active`), per candidate."""

    envs: int
    plane: np.ndarray       # (nc,) contact point below the ground
    ball_plane: int         # ball below the ground
    box: np.ndarray         # (nbox,) ball inside a collision box's reach
    damped: np.ndarray      # (nb,) body with an active ground contact
    loaded: np.ndarray      # (nb,) body with any active contact


def contact_activity(model: RobotModel, cfg: SceneConfig, state_in: Tensor
                     ) -> ContactActivity:
    """Which contacts `state_in` activates, from the plain kinematics."""
    m = model
    s = state_in.t()
    q, _, base_pos, base_quat, _, ball_pos = torch.split(
        s, [m.nq, m.nq, 3, 4, 6, 3, 4, 3, 3], dim=-1)[:6]
    fr = kin.forward_kinematics(m, q, base_pos, base_quat)
    B = s.shape[0]

    def on_body(hit, body):
        out = torch.zeros((B, m.nb), dtype=torch.int32, device=s.device)
        return out.index_add_(1, torch.as_tensor(body, device=s.device)
                              .long(), hit.int()) > 0

    cb = torch.as_tensor(m.cpoint_body, device=s.device).long()
    cz = fr.pos[:, cb, 2] + torch.einsum(
        "ecj,cj->ec", fr.rot[:, cb, 2, :],
        kin.model_const(m, "cpoint_pos", fr.pos))
    plane = cz < 0
    nbox = len(m.box_body)
    box = torch.zeros((B, nbox), dtype=torch.bool, device=s.device)
    ball_plane = torch.zeros(B, dtype=torch.bool, device=s.device)
    if cfg.has_ball and nbox:
        bb = torch.as_tensor(m.box_body, device=s.device).long()
        Rbox = fr.rot[:, bb] @ kin.model_const(m, "box_rot", fr.pos)
        box_c = fr.pos[:, bb] + torch.einsum(
            "ekij,kj->eki", fr.rot[:, bb],
            kin.model_const(m, "box_pos", fr.pos))
        local = torch.einsum("ekji,ekj->eki", Rbox, ball_pos[:, None] - box_c)
        half = kin.model_const(m, "box_half", fr.pos)
        d = local - torch.maximum(torch.minimum(local, half), -half)
        box = torch.sqrt((d * d).sum(-1) + 1e-12) < cfg.ball_radius
    if cfg.has_ball:
        ball_plane = ball_pos[:, 2] < cfg.ball_radius
    damped = on_body(plane, m.cpoint_body)
    loaded = damped | on_body(box, m.box_body)

    def count(x):
        return x.sum(0).cpu().numpy().astype(np.int64)

    return ContactActivity(envs=B, plane=count(plane),
                           ball_plane=int(ball_plane.sum()), box=count(box),
                           damped=count(damped), loaded=count(loaded))


# Sparsity patterns of 3-vectors and 3x3 matrices: 0 zero, 1 a unit entry
# (+-1, a product with it is a copy), 2 a general value.
_ZERO3, _GEN3 = (0, 0, 0), (2, 2, 2)
_DIAG = ((2, 0, 0), (0, 2, 0), (0, 0, 2))
_OFFDIAG = ((0, 2, 2), (2, 0, 2), (2, 2, 0))
_DENSE = (_GEN3,) * 3
_NONE = (_ZERO3,) * 3


def _sum_cost(pairs):
    """Cost and pattern of sum(u_j * v_j) over (u_j, v_j) entry pairs."""
    terms = [(u, v) for u, v in pairs if u and v]
    if not terms:
        return 0, 0
    muls = sum(1 for u, v in terms if u == 2 and v == 2)
    pattern = 1 if terms == [(1, 1)] else 2
    return muls + len(terms) - 1, pattern


def _gmv(blocks):
    """M1 x1 + M2 x2 + ...: (cost, pattern) for (matrix, vector) blocks."""
    cost, out = 0, []
    for i in range(3):
        c, pat = _sum_cost([(M[i][j], x[j]) for M, x in blocks
                            for j in range(3)])
        cost += c
        out.append(pat)
    return cost, tuple(out)


def _is_unit(v) -> bool:
    v = np.asarray(v)
    return np.count_nonzero(v) == 1 and float(np.abs(v).sum()) == 1.0


def _const_mv(v) -> int:
    """Runtime 3x3 times the constant 3-vector v."""
    k = int(np.count_nonzero(v))
    return 0 if k == 0 or _is_unit(v) else 3 * (2 * k - 1)


def _const_offset(v) -> int:
    """p + R v for a runtime p, R and a constant offset v."""
    return _const_mv(v) + (3 if np.count_nonzero(v) else 0)


def _const_mm(M) -> int:
    """Runtime 3x3 times the constant 3x3 M, column by column."""
    return sum(_const_mv(col) for col in np.asarray(M).T)


def flop_terms(model: RobotModel, cfg: SceneConfig, act: ContactActivity
               ) -> dict:
    """Floating-point operations one substep needs over `act.envs` envs,
    by stage of csrc/substep_body.cuh.

    Add, multiply, divide, sqrt, sin and cos count 1; compares, min/max and
    negation count 0.  Work on entries that are structurally zero or one is
    not counted: identity table rotations and coordinate joint axes, the
    unit base Jacobian columns, the diagonal A and zero-diagonal Bm of the
    contact-damped inertia, the tree sparsity of H and its Cholesky factor,
    and every contact this run's data leaves inactive (only its
    penetration test counts).  Adds into a zero accumulator are counted.
    """
    m = model
    nb, nq, B = m.nb, m.nq, act.envs
    nv = nq + 6
    mask = kin.ancestor_mask(m)
    has_ball = cfg.has_ball
    t = {}

    # Forward kinematics.
    t["fk_base_rotation"] = 35 * B
    fk = 0
    for b in range(1, nb):
        d = b - 1
        ax = np.asarray(m.axis[d])
        fk += _const_offset(m.tree_pos[b]) + _const_mm(m.tree_rot[b])
        fk += 20 if _is_unit(ax) else 66          # sin, cos, R_pre @ R_j
        fk += _const_mv(ax)                       # world axis
    t["fk_bodies"] = fk * B
    t["fk_com"] = sum(_const_offset(c) for c in m.com) * B

    # Body velocities and qdd=0 bias accelerations; AL0 of the base is 0.
    t["velocities"] = (24 + sum(81 if m.parent[b] == 0 else 96
                                for b in range(1, nb))) * B

    # Ground contacts: every point is tested (pw.z), active ones do the rest.
    kc = [int(np.count_nonzero(c)) for c in m.cpoint_pos]
    t["plane_test"] = sum(2 * k for k in kc) * B
    t["plane_active"] = int(sum(
        n * (4 * k + 81 + (s >= 0))
        for n, k, s in zip(act.plane, kc, m.cpoint_sensor)))

    # Ball: plane, each box (distance test; active boxes do the rest),
    # gravity.
    t["ball_plane"] = (B + 31 * act.ball_plane) if has_ball else 0
    nbox = len(m.box_body)
    t["box_test"] = sum(_const_offset(m.box_pos[k]) + _const_mm(m.box_rot[k])
                        + 29 for k in range(nbox)) * B if has_ball else 0
    t["box_active"] = 115 * int(act.box.sum()) if has_ball else 0
    t["ball_gravity"] = 6 * B if has_ball else 0

    # Right-hand side: Stable-PD torque, joint friction.
    t["joint_pd_friction"] = 10 * nq * B

    # Per body: Jacobian columns, world inertia, the damped inertia G,
    # wrench, G @ columns, tau and the H upper triangle.
    jac = inertia = wrench = colmul = dots = tau = pairs = 0
    pattern = np.zeros((nv, nv), dtype=bool)     # H, joints-first order
    for b in range(nb):
        joints = [d for d in range(nq) if mask[b, d]]
        cols = [("lin", k) for k in range(3)] + [("ang", k) for k in range(3)] \
            + [("joint", d) for d in joints]
        jac += (3 if b else 0) + 12 * len(joints)
        inertia += 1 + _const_mm(m.inertia[b]) + 30 + 6
        # f_net = F - (a0 - g) m: 6; n_net = N - I alpha0 - w x I w: 24,
        # with I alpha0 (15 + 3) off the base; F and N (3 + 3) if loaded.
        wrench += (30 + (18 if b else 0)) * B + 6 * int(act.loaded[b])
        n_damped = int(act.damped[b])
        for G, n_env in (((_DIAG, _NONE, _NONE, _DENSE), B - n_damped),
                         ((_DIAG, _OFFDIAG, _OFFDIAG, _DENSE), n_damped)):
            c_mul, c_dot, nonzero = _body_products(cols, G)
            colmul += c_mul * n_env
            dots += c_dot * n_env
            pairs += len(nonzero) * n_env
            for c1, c2 in nonzero:
                p1, p2 = _perm(c1, nq), _perm(c2, nq)
                pattern[max(p1, p2), min(p1, p2)] = True
        # tau[c] += lin . f_net + ang . n_net; the base rows start at zero.
        tau += sum(_sum_cost([(u, 2) for u in lin + ang])[0]
                   for lin, ang in map(_column, cols)) * B
        tau += len(cols) * B
    t["jacobian_columns"] = jac * B
    t["world_inertia"] = inertia * B
    t["contact_damped_inertia"] = 29 * int(act.damped.sum())
    t["wrench"] = wrench
    t["inertia_times_columns"] = colmul
    t["h_entries"] = dots
    # Each contribution is added into H; an entry's first one is a write.
    t["h_accumulate"] = pairs - int(pattern.sum()) * B
    t["tau"] = tau - 6 * B
    t["h_diagonal"] = 4 * nq * B

    # Joints-first Cholesky and the two substitutions on H's pattern.
    L = pattern.copy()
    chol = subst = 0
    for j in range(nv):
        chol += 2
        rows = [r for r in range(j + 1, nv) if L[r, j]]
        chol += len(rows)
        for r in rows:
            for k in rows:
                if k <= r:
                    chol += 2
                    L[r, k] = True
        subst += 2 * (1 + 2 * len(rows))
    t["cholesky"] = chol * B
    t["substitutions"] = subst * B

    # Semi-implicit Euler.
    t["integrate_joints"] = 4 * nq * B
    t["integrate_base"] = (12 + 6 + 54) * B
    t["integrate_ball"] = 72 * B if has_ball else 0
    return t


def _column(col):
    """(lin, ang) patterns of a Jacobian column: a base linear column is a
    unit vector; a base angular one is e_k x r (zero at k) over e_k."""
    kind, k = col
    unit = tuple(int(i == k) for i in range(3))
    if kind == "lin":
        return unit, _ZERO3
    if kind == "ang":
        return tuple(0 if i == k else 2 for i in range(3)), unit
    return _GEN3, _GEN3


def _body_products(cols, G):
    """One body's G @ columns and H entries, for G = ((A, Bm), (Bm^T, E)).

    Returns the cost of G @ every column, the cost of every entry
    lin_a . top_a2 + ang_a . bot_a2 (a <= a2, as the kernel forms them) and
    the column pairs whose entry is not structurally zero.
    """
    A, Bm, Bt, E = G
    c_mul, prods = 0, []
    for c in cols:
        lin, ang = _column(c)
        c1, top = _gmv([(A, lin), (Bm, ang)])
        c2, bot = _gmv([(Bt, lin), (E, ang)])
        c_mul += c1 + c2
        prods.append((top, bot))
    c_dot, nonzero = 0, []
    for a, ca in enumerate(cols):
        lin, ang = _column(ca)
        for a2 in range(a, len(cols)):
            top, bot = prods[a2]
            cost, pat = _sum_cost(list(zip(lin + ang, top + bot)))
            c_dot += cost
            if pat:
                nonzero.append((ca, cols[a2]))
    return c_mul, c_dot, nonzero


def _perm(col, nq: int) -> int:
    """Row of a Jacobian column in the joints-first order of H."""
    kind, k = col
    return k if kind == "joint" else nq + (k if kind == "lin" else 3 + k)


def all_active(model: RobotModel, envs: int) -> ContactActivity:
    """Every contact of `envs` envs penetrating: the most operations any
    data can ask of a launch."""
    nbox = len(model.box_body)
    return ContactActivity(
        envs=envs, plane=np.full(len(model.cpoint_body), envs, np.int64),
        ball_plane=envs, box=np.full(nbox, envs, np.int64),
        damped=np.full(model.nb, envs, np.int64),
        loaded=np.full(model.nb, envs, np.int64))


class Bound(NamedTuple):
    """The least time of launches on the card: the larger of their bytes
    over the memory rate and their operations over the fp32 rate."""

    ms: float
    by: str                 # "bytes" or "operations"
    bytes: int
    flops: int


def launch_bound(model: RobotModel, cfg: SceneConfig, envs: int, peaks: dict,
                 act: ContactActivity | None = None) -> Bound:
    """The bound of launches over `envs` env-substeps in all.  Without
    `act`, the operations are counted with every contact active; that is
    exact only where the bytes bound the launch even then, and anything
    else raises, since the operations then depend on the data."""
    nbytes = bytes_per_env(model, cfg.has_ball) * envs
    flops = int(sum(flop_terms(model, cfg, act or all_active(model, envs))
                    .values()))
    t_b = nbytes / peaks["bytes_per_s"] * 1e3
    t_o = flops / peaks["fp32_flops_per_s"] * 1e3
    if act is None and t_o > t_b:
        raise ValueError("the operations bound these launches on some data: "
                         "pass the contact activity of the launches' inputs")
    return Bound(max(t_b, t_o), "bytes" if t_b >= t_o else "operations",
                 nbytes, flops)
