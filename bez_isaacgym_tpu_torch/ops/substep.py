"""The physics substep as a hand-written CUDA kernel, and its plain version.

Replaces the TPU kernel `_substep_kernel` / `make_pallas_step_fn` of
`bez_isaacgym_tpu/ops/pallas_step.py`.  The kernel (`csrc/substep.cu`,
schedule in `csrc/substep_body.cuh`) runs one substep for one env per warp,
its state in shared memory, on (rows, B) float32 structure-of-arrays
buffers:

- state_in  (2 nq + 26, B): q, qd, base_pos, base_quat, base_u, ball_pos,
  ball_quat, ball_vel, ball_ang;
- params_in (8 nq + nb + 4, B): kp, kd, effort, armature, joint_friction,
  mass_scale, mu, gravity, targets, dof_lower, dof_upper;
- out       (2 nq + 34 + 3 nb, B): the new state (same rows as state_in), the
  8 foot-sensor normals, the nb x 3 body contact forces.

`substep` launches the kernel for CUDA tensors and runs `substep_plain` (the
port's plain engine) for CPU tensors; nothing falls back from one to the
other.  `make_kernel_step_fn` is the batched step over these buffers.
`contact_activity` and `flop_terms` count the operations a substep needs on
given inputs, for the kernel's bound.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from bez_isaacgym_tpu_torch.models.robot import DynParams, RobotModel
from bez_isaacgym_tpu_torch.ops import _build, engine
from bez_isaacgym_tpu_torch.ops import kinematics as kin
from bez_isaacgym_tpu_torch.ops.engine import PhysicsState, SceneConfig

Tensor = torch.Tensor

# Capacities of the C struct (csrc/substep_body.cuh).
MAX_NB, MAX_NC, MAX_BOX = 24, 256, 32
MAX_NV = MAX_NB - 1 + 6
MAX_SLOT, MAX_ITEM = MAX_NB * MAX_NV, MAX_NV * (MAX_NV + 1) // 2 + MAX_NV
MAX_PAIR, MAX_CHOL, MAX_BACK = 2048, 512, 320

_F3 = ctypes.c_float * 3
_F9 = ctypes.c_float * 9


class _Tables(ctypes.Structure):
    """Mirror of `struct SubstepTables` in csrc/substep_body.cuh."""

    _fields_ = (
        [(n, ctypes.c_int) for n in ("nb", "nq", "nc", "nbox", "has_ball",
                                     "n_level", "n_slot", "n_item",
                                     "n_limb", "n_chol_step",
                                     "n_back_step")]
        + [(n, ctypes.c_float) for n in (
            "h", "kn", "cn", "vt_eps", "ball_kn", "ball_cn", "ball_radius",
            "ball_mass", "ball_inertia", "ball_rolling_friction",
            "max_joint_vel", "max_base_lin_vel", "max_base_ang_vel",
            "max_ball_vel", "friction_vel_scale")]
        + [("parent", ctypes.c_int * MAX_NB),
           ("level_off", ctypes.c_int * (MAX_NB + 1)),
           ("level_body", ctypes.c_int * MAX_NB),
           ("cp_off", ctypes.c_int * (MAX_NB + 1)),
           ("limb_off", ctypes.c_int * (MAX_NB + 1)),
           ("chol_off", ctypes.c_int * (MAX_NB + 1)),
           ("chol_item", ctypes.c_int * MAX_CHOL),
           ("back_off", ctypes.c_int * (MAX_NB + 1)),
           ("back_item", ctypes.c_int * MAX_BACK),
           ("slot_code", ctypes.c_int * MAX_SLOT),
           ("item_dst", ctypes.c_int * MAX_ITEM),
           ("item_col", ctypes.c_int * MAX_ITEM),
           ("item_joint", ctypes.c_int * MAX_ITEM),
           ("item_off", ctypes.c_int * (MAX_ITEM + 1)),
           ("pair", ctypes.c_int * MAX_PAIR),
           ("tree_pos", _F3 * MAX_NB), ("tree_rot", _F9 * MAX_NB),
           ("axis", _F3 * MAX_NB), ("com", _F3 * MAX_NB),
           ("mass", ctypes.c_float * MAX_NB), ("inertia", _F9 * MAX_NB),
           ("cp_sensor", ctypes.c_int * MAX_NC),
           ("cp_pos", _F3 * MAX_NC),
           ("box_body", ctypes.c_int * MAX_BOX), ("box_pos", _F3 * MAX_BOX),
           ("box_rot", _F9 * MAX_BOX), ("box_half", _F3 * MAX_BOX)])


def _schedule(model: RobotModel, mask: np.ndarray) -> dict:
    """The kernel's work lists for one model (see SubstepTables).

    Slots: every (body, Jacobian column) pair.  Items: every H entry that
    some body or a DOF's diagonal term fills, and every right-hand side
    row, each with its terms in body order, sorted by descending term
    count.  Limbs: the DOF ranges below each child of the base; the kernel
    needs each limb's DOFs to be consecutive.  The steps of the limbs'
    elimination and back substitution, every limb side by side.
    """
    nb, nq = model.nb, model.nq
    nv = nq + 6
    active = np.concatenate([np.ones((nb, 6), bool), mask], axis=1)
    slot_of, slot_code = {}, []
    for b in range(nb):
        for c in np.flatnonzero(active[b]):
            slot_of[b, int(c)] = len(slot_code)
            slot_code.append(b | int(c) << 8)

    def unperm(p):
        return 6 + p if p < nq else p - nq

    items = []                    # (dst, col, joint, pairs)
    for p in range(nv):
        for q in range(p + 1):
            c1, c2 = sorted((unperm(p), unperm(q)))
            pairs = [b | slot_of[b, c2] << 16 for b in range(nb)
                     if active[b, c1] and active[b, c2]]
            joint = p if p == q and p < nq else -1
            if pairs or joint >= 0:
                items.append((p * (p + 1) // 2 + q, c1, joint, pairs))
    for c in range(nv):
        items.append((nv * (nv + 1) // 2 + (nq + c if c < 6 else c - 6), c,
                      c - 6 if c >= 6 else -1,
                      [b | b << 16 for b in range(nb)
                       if active[b, c]]))
    items.sort(key=lambda it: -len(it[3]))

    root = []                     # the base's child above each DOF's body
    for d in range(nq):
        b = d + 1
        while model.parent[b] != 0:
            b = model.parent[b]
        root.append(b)
    starts = [d for d in range(nq) if d == 0 or root[d] != root[d - 1]]
    if len(starts) != len(set(root)):
        raise ValueError(f"model {model.name}: a limb's DOFs are not "
                         "consecutive")
    limbs = list(zip(starts, starts[1:] + [nq]))
    steps = max((e - a for a, e in limbs), default=0)
    chol_off, chol_item, back_off, back_item = [0], [], [0], []
    for t in range(steps):
        for a, e in limbs:
            if e - a > t:
                j = a + t
                chol_item += [j | r << 8 | min(r, e - 1) << 16
                              for r in [*range(j, e), *range(nq, nv)]]
        chol_off.append(len(chol_item))
    for t in reversed(range(steps)):
        for a, e in limbs:
            if e - a > t:
                back_item += [(a + t) | k << 8 for k in range(a, a + t + 1)]
        back_off.append(len(back_item))
    return {"slot_code": slot_code,
            "item_dst": [it[0] for it in items],
            "item_col": [it[1] for it in items],
            "item_joint": [it[2] for it in items],
            "item_off": np.concatenate(
                [[0], np.cumsum([len(it[3]) for it in items])]),
            "pair": [pr for it in items for pr in it[3]],
            "limb_off": starts + [nq],
            "chol_off": chol_off, "chol_item": chol_item,
            "back_off": back_off, "back_item": back_item}


def state_rows(nq: int) -> int:
    return 2 * nq + 26


def param_rows(nq: int, nb: int) -> int:
    return 8 * nq + nb + 4


def out_rows(nq: int, nb: int) -> int:
    return 2 * nq + 34 + 3 * nb


class KernelTables:
    """A model's topology and scene constants laid out for the kernel.

    Built once per (model, scene); `on(device, lib)` checks the layout
    against the built library and copies the table to a device the first
    time it is asked for there.
    """

    def __init__(self, model: RobotModel, cfg: SceneConfig):
        nb, nq = model.nb, model.nq
        nc, nbox = len(model.cpoint_body), len(model.box_body)
        if nb > MAX_NB or nc > MAX_NC or nbox > MAX_BOX or nq >= 32:
            raise ValueError(
                f"model {model.name} exceeds the kernel's capacity "
                f"(nb {nb}/{MAX_NB}, contacts {nc}/{MAX_NC}, "
                f"boxes {nbox}/{MAX_BOX})")
        self.model, self.cfg = model, cfg
        self.h = cfg.dt / cfg.substeps
        self.mask = kin.ancestor_mask(model)
        # Contact points sorted by body (stably, so each body sums its own
        # in the original order); a sensor slot must lie on one body, so
        # that one lane sums it.
        cp_body = np.asarray(model.cpoint_body, dtype=np.int64)
        cp_order = np.argsort(cp_body, kind="stable")
        for slot in set(np.asarray(model.cpoint_sensor).tolist()) - {-1}:
            if len(set(cp_body[np.asarray(model.cpoint_sensor) == slot])) > 1:
                raise ValueError(f"model {model.name}: sensor slot {slot} "
                                 "spans several bodies")
        depth = np.zeros(nb, dtype=np.int64)
        for b in range(1, nb):
            depth[b] = depth[model.parent[b]] + 1
        sched = _schedule(model, self.mask)
        if len(sched["pair"]) > MAX_PAIR:
            raise ValueError(
                f"model {model.name} exceeds the kernel's capacity "
                f"(H and rhs terms {len(sched['pair'])}/{MAX_PAIR})")
        co = cfg.coeffs
        t = _Tables(
            nb=nb, nq=nq, nc=nc, nbox=nbox, has_ball=int(cfg.has_ball),
            n_level=int(depth.max()) + 1, n_slot=len(sched["slot_code"]),
            n_item=len(sched["item_dst"]),
            n_limb=len(sched["limb_off"]) - 1,
            n_chol_step=len(sched["chol_off"]) - 1,
            n_back_step=len(sched["back_off"]) - 1,
            h=self.h, kn=co.kn, cn=co.cn, vt_eps=co.vt_eps,
            ball_kn=co.ball_kn, ball_cn=co.ball_cn,
            ball_radius=cfg.ball_radius, ball_mass=cfg.ball_mass,
            ball_inertia=cfg.ball_inertia,
            ball_rolling_friction=cfg.ball_rolling_friction,
            max_joint_vel=cfg.max_joint_vel,
            max_base_lin_vel=cfg.max_base_lin_vel,
            max_base_ang_vel=cfg.max_base_ang_vel,
            max_ball_vel=cfg.max_ball_vel,
            friction_vel_scale=cfg.friction_vel_scale)

        def fill(field, values):
            arr = np.ctypeslib.as_array(getattr(t, field))
            values = np.asarray(values).reshape((len(values),) + arr.shape[1:])
            arr[:len(values)] = values

        fill("parent", model.parent)
        fill("level_off", np.searchsorted(np.sort(depth),
                                          np.arange(depth.max() + 2)))
        fill("level_body", np.argsort(depth, kind="stable"))
        fill("cp_off", np.searchsorted(cp_body[cp_order], np.arange(nb + 1)))
        for field, values in sched.items():
            fill(field, values)
        fill("tree_pos", model.tree_pos)
        fill("tree_rot", model.tree_rot.reshape(nb, 9))
        fill("axis", model.axis)
        fill("com", model.com)
        fill("mass", model.mass)
        fill("inertia", model.inertia.reshape(nb, 9))
        if nc:
            fill("cp_sensor", np.asarray(model.cpoint_sensor)[cp_order])
            fill("cp_pos", np.asarray(model.cpoint_pos)[cp_order])
        if nbox:
            fill("box_body", model.box_body)
            fill("box_pos", model.box_pos)
            fill("box_rot", np.asarray(model.box_rot).reshape(nbox, 9))
            fill("box_half", model.box_half)
        self.struct = t
        self._on: dict[torch.device, Tensor] = {}

    def on(self, device: torch.device, lib: ctypes.CDLL) -> Tensor:
        buf = self._on.get(device)
        if buf is None:
            if lib.bez_substep_tables_size() != ctypes.sizeof(_Tables):
                raise RuntimeError("SubstepTables layout differs between "
                                   "csrc/substep_body.cuh and ops/substep.py")
            raw = np.frombuffer(bytes(self.struct), dtype=np.uint8).copy()
            buf = torch.from_numpy(raw).to(device)
            self._on[device] = buf
        return buf


def _check(tables: KernelTables, state_in: Tensor, params_in: Tensor):
    nq, nb = tables.model.nq, tables.model.nb
    for name, x, rows in (("state_in", state_in, state_rows(nq)),
                          ("params_in", params_in, param_rows(nq, nb))):
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: float32 expected, got {x.dtype}")
        if x.dim() != 2 or x.shape[0] != rows:
            raise ValueError(f"{name}: ({rows}, B) expected, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if state_in.shape[1] != params_in.shape[1]:
        raise ValueError("state_in and params_in disagree on B")
    if state_in.shape[1] == 0:
        raise ValueError("substep needs at least one env (B = 0)")
    if state_in.device != params_in.device:
        raise ValueError("state_in and params_in are on different devices")


def substep(tables: KernelTables, state_in: Tensor,
            params_in: Tensor) -> Tensor:
    """One substep of length tables.h for every env: (out_rows, B).

    CUDA tensors: launches the kernel (raises if it cannot).  CPU tensors:
    the plain version.  Any other device raises.
    """
    _check(tables, state_in, params_in)
    dev = state_in.device
    if dev.type == "cpu":
        return substep_plain(tables, state_in, params_in)
    if dev.type != "cuda":
        raise ValueError(f"substep: unsupported device {dev}")
    lib = _build.load()
    m = tables.model
    B = state_in.shape[1]
    out = torch.empty((out_rows(m.nq, m.nb), B), dtype=torch.float32,
                      device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.bez_substep_launch(tables.on(dev, lib).data_ptr(),
                                ctypes.addressof(tables.struct),
                                state_in.data_ptr(), params_in.data_ptr(),
                                out.data_ptr(), B, stream)
    if rc != 0:
        raise RuntimeError(f"substep kernel launch failed: cudaError {rc}")
    # A call that a CUDA graph records launches nothing: the graph's
    # replays launch, and only a device trace sees those.
    if not torch.cuda.is_current_stream_capturing():
        substep.launches += 1
    return out


# Launches made from Python (not the replays of a captured graph).
substep.launches = 0


class LaunchConfig(NamedTuple):
    """How the kernel is launched for one model on the current card."""

    envs_per_block: int
    threads_per_block: int
    shared_bytes_per_block: int
    blocks_per_sm: int          # resident, by the CUDA occupancy calculator


def launch_config(tables: KernelTables) -> LaunchConfig:
    """The kernel's launch configuration and occupancy for `tables`' model
    (builds the kernel; needs a CUDA device)."""
    lib = _build.load()
    cfg = (ctypes.c_int * 4)()
    rc = lib.bez_substep_config(ctypes.addressof(tables.struct), cfg)
    if rc != 0:
        raise RuntimeError(f"substep kernel configuration failed: "
                           f"cudaError {rc}")
    return LaunchConfig(*cfg)


# ---------------------------------------------------------------------------
# Packing between PhysicsState / DynParams and the kernel's buffers.
# ---------------------------------------------------------------------------

_STATE_FIELDS = ("q", "qd", "base_pos", "base_quat", "base_u", "ball_pos",
                 "ball_quat", "ball_vel", "ball_ang")


def pack_state(states: PhysicsState) -> Tensor:
    """(B, ...) state fields -> (state_rows, B) contiguous."""
    return torch.cat([getattr(states, f) for f in _STATE_FIELDS],
                     dim=-1).t().contiguous()


def pack_params(model: RobotModel, params: DynParams, targets: Tensor
                ) -> Tensor:
    """Per-env params (broadcast to B) + targets -> (param_rows, B).

    `ground_friction` may be a scalar or (B,); joint limits default to the
    model's when None.
    """
    B = targets.shape[0]
    nq, nb = model.nq, model.nb

    def col(x, d):
        x = torch.as_tensor(x, dtype=torch.float32, device=targets.device)
        return x.reshape(-1, d).expand(B, d) if x.numel() != B * d \
            else x.reshape(B, d)

    lower = params.dof_lower if params.dof_lower is not None \
        else model.dof_lower
    upper = params.dof_upper if params.dof_upper is not None \
        else model.dof_upper
    parts = [col(params.kp, nq), col(params.kd, nq), col(params.effort, nq),
             col(params.armature, nq), col(params.joint_friction, nq),
             col(params.mass_scale, nb), col(params.ground_friction, 1),
             col(params.gravity, 3), col(targets, nq), col(lower, nq),
             col(upper, nq)]
    return torch.cat(parts, dim=-1).t().contiguous()


def unpack_out(model: RobotModel, out: Tensor) -> PhysicsState:
    """(out_rows, B) -> PhysicsState with a leading env axis (views)."""
    nq, nb = model.nq, model.nb
    x = out.t()
    sizes = [nq, nq, 3, 4, 6, 3, 4, 3, 3, 8, 3 * nb]
    parts = list(torch.split(x, sizes, dim=-1))
    parts[-1] = parts[-1].reshape(-1, nb, 3)
    return PhysicsState(*parts)


def substep_plain(tables: KernelTables, state_in: Tensor,
                  params_in: Tensor) -> Tensor:
    """The kernel's function through the plain engine (`_prepare`,
    `solve_spd_ordered`, `_integrate`), on the same buffers."""
    m = tables.model
    nq, nb = m.nq, m.nb
    s = state_in.t()
    state = PhysicsState(*torch.split(s, [nq, nq, 3, 4, 6, 3, 4, 3, 3],
                                      dim=-1),
                         sensor_normal=None, body_contact_force=None)
    p = params_in.t()
    (kp, kd, eff, arm, jf, ms, mu, grav, tgt, lo, hi) = torch.split(
        p, [nq] * 5 + [nb, 1, 3, nq, nq, nq], dim=-1)
    params = DynParams(kp=kp, kd=kd, effort=eff, armature=arm,
                       joint_friction=jf, mass_scale=ms,
                       ground_friction=mu[:, 0], gravity=grav,
                       dof_lower=lo, dof_upper=hi)
    new = engine.substep(m, tables.cfg, tables.mask, params, state, tgt,
                         tables.h)
    return torch.cat([getattr(new, f) for f in _STATE_FIELDS]
                     + [new.sensor_normal,
                        new.body_contact_force.reshape(-1, 3 * nb)],
                     dim=-1).t().contiguous()


def make_kernel_step_fn(model: RobotModel, cfg: SceneConfig):
    """Batched step through `substep`: step_fn(params, states, targets).

    Same signature and layout as engine.make_batched_step_fn; one launch
    per substep, chaining the state rows of each output into the next.
    """
    tables = KernelTables(model, cfg)
    n_state = state_rows(model.nq)

    def step_fn(params: DynParams, states: PhysicsState,
                targets: Tensor) -> PhysicsState:
        x = pack_state(states)
        p = pack_params(model, params, targets)
        for _ in range(cfg.substeps):
            out = substep(tables, x, p)
            x = out[:n_state]
        return unpack_out(model, out)

    step_fn.tables = tables
    return step_fn


class ContactActivity(NamedTuple):
    """How many of the batch's envs have each contact penetrating
    (pen > 0, the kernel's `active`), per candidate."""

    envs: int
    plane: np.ndarray       # (nc,) contact point below the ground
    ball_plane: int         # ball below the ground
    box: np.ndarray         # (nbox,) ball inside a collision box's reach
    damped: np.ndarray      # (nb,) body with an active ground contact
    loaded: np.ndarray      # (nb,) body with any active contact


def contact_activity(tables: KernelTables, state_in: Tensor
                     ) -> ContactActivity:
    """Which contacts `state_in` activates, from the plain kinematics."""
    m, cfg = tables.model, tables.cfg
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


def flop_terms(tables: KernelTables, act: ContactActivity) -> dict:
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
    m, cfg = tables.model, tables.cfg
    nb, nq, B = m.nb, m.nq, act.envs
    nv = nq + 6
    mask = tables.mask
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


# The ball's state rows: ball_pos, ball_quat, ball_vel, ball_ang.
BALL_ROWS = 13

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and FP32 (non-tensor).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def bytes_per_env(model: RobotModel, has_ball: bool = True) -> int:
    """Bytes one launch must move per env: every input row read once and
    every output row written once, float32.  Without a ball the substep
    needs none of the ball's rows, in or out (the kernel copies them
    through, which this count leaves out)."""
    nq, nb = model.nq, model.nb
    rows = state_rows(nq) + param_rows(nq, nb) + out_rows(nq, nb)
    return 4 * (rows - (0 if has_ball else 2 * BALL_ROWS))


class Bound(NamedTuple):
    """The least time one launch could take on the card: the larger of
    its bytes over HBM's rate and its operations over the fp32 peak."""

    ms: float
    by: str                 # "bytes" or "operations"
    bytes: int
    flops: int


def bound(tables: KernelTables, state_in: Tensor) -> Bound:
    """The bound of one launch on `state_in`, counting the contacts this
    data activates and the ball's work only where the scene has one."""
    nbytes = bytes_per_env(tables.model, tables.cfg.has_ball) \
        * state_in.shape[1]
    flops = sum(flop_terms(tables, contact_activity(tables, state_in))
                .values())
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_o = flops / PEAK_FP32_PER_S * 1e3
    return Bound(max(t_b, t_o), "bytes" if t_b >= t_o else "operations",
                 nbytes, flops)
