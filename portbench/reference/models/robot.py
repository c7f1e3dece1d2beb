"""RobotSpec -> RobotModel: flat arrays for the articulated-body step.

This is the analog of Isaac Gym's `prepare_sim` tensor pipeline setup
(bez_isaacgym/tasks/base/vec_task.py:189): everything the
per-step kernels need is laid out as dense numpy arrays up front, so the
traced step function closes over static shapes only.

Design notes:
- Fixed joints are merged: their subtree mass properties are composed into the
  nearest movable ancestor (rigidly identical dynamics to simulating them as
  bodies, which is what PhysX does with collapseFixedJoints=False), and their
  frames are kept as named *sites* (IMU, cleats, camera).
- DOF order is alphabetical by joint name, matching Isaac Gym asset DOF order
  and therefore the reference `Joints` enum (kick_env.py:23-41): head(2),
  left_arm(2), left_leg(6), right_arm(2), right_leg(6).
- Movable body i (i>=1) is the child link of DOF i-1; body 0 is the free root.
- Collision is exported as (a) point-contact candidates (box corners) for the
  ground plane and (b) oriented boxes for sphere-vs-box tests with the ball.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from portbench.reference.models.urdf import RobotSpec, rpy_to_matrix

_MOVABLE = ("revolute", "continuous", "prismatic")


@dataclass(frozen=True)
class Site:
    """A named frame rigidly attached to a movable body."""

    body: int
    pos: np.ndarray      # (3,) in body frame
    rot: np.ndarray      # (3,3) body->site


@dataclass
class RobotModel:
    """Static articulated-body model (numpy; read once by the physics step)."""

    name: str
    nb: int                      # number of movable bodies (root included)
    nq: int                      # number of actuated DOFs (= nb - 1)
    parent: np.ndarray           # (nb,) parent body index, -1 for root
    tree_pos: np.ndarray         # (nb,3) joint origin in parent body frame
    tree_rot: np.ndarray         # (nb,3,3) parent->child rotation at q=0
    axis: np.ndarray             # (nq,3) joint axis in child body frame
    mass: np.ndarray             # (nb,)
    com: np.ndarray              # (nb,3) COM offset in body frame
    inertia: np.ndarray          # (nb,3,3) about COM, body-frame axes
    dof_lower: np.ndarray        # (nq,)
    dof_upper: np.ndarray        # (nq,)
    dof_effort: np.ndarray       # (nq,) URDF effort limit
    dof_velocity: np.ndarray     # (nq,) URDF velocity limit
    joint_names: list[str] = field(default_factory=list)
    body_names: list[str] = field(default_factory=list)
    sites: dict[str, Site] = field(default_factory=dict)
    # Ground-contact candidate points.
    cpoint_pos: np.ndarray = None     # (nc,3) in body frame
    cpoint_body: np.ndarray = None    # (nc,) body index
    cpoint_sensor: np.ndarray = None  # (nc,) foot-sensor slot 0..7, else -1
    # Collision boxes (ball vs robot).
    box_body: np.ndarray = None       # (nbx,)
    box_pos: np.ndarray = None        # (nbx,3)
    box_rot: np.ndarray = None        # (nbx,3,3)
    box_half: np.ndarray = None       # (nbx,3)

    def joint_index(self, name: str) -> int:
        return self.joint_names.index(name)

    def body_index(self, name: str) -> int:
        return self.body_names.index(name)


class DynParams(NamedTuple):
    """Per-run (and per-env under DR) dynamics parameters.

    Tensors at runtime (leading env axis under DR); defaults mirror the reference actuator overrides
    (kick_env.py:322-329) and plane config (bez_kick.yaml:13-16).
    """

    kp: np.ndarray               # (nq,) PD stiffness   [100]
    kd: np.ndarray               # (nq,) PD damping     [7.5]
    effort: np.ndarray           # (nq,) torque clamp   [2.5]
    armature: np.ndarray         # (nq,) reflected inertia [0.001]
    joint_friction: np.ndarray   # (nq,) Coulomb joint friction [0.1]
    mass_scale: np.ndarray       # (nb,) DR mass scaling [1]
    ground_friction: float = 1.0
    restitution: float = 0.0
    gravity: np.ndarray = None   # (3,)
    dof_lower: np.ndarray = None  # (nq,) joint limits (DR-randomizable,
    dof_upper: np.ndarray = None  # bez_kick.yaml:205-214); None = model's


def _compose_inertia(entries):
    """Combine [(m, com(3,), I(3,3))...] into one (m, com, I) about new COM."""
    m_tot = sum(e[0] for e in entries)
    if m_tot <= 0.0:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    com = sum(e[0] * e[1] for e in entries) / m_tot
    I = np.zeros((3, 3))
    for m, c, Ic in entries:
        d = c - com
        I = I + Ic + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    return m_tot, com, I


def _inertia_matrix(vals6):
    ixx, ixy, ixz, iyy, iyz, izz = vals6
    return np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])


def _box_corners(half):
    sx, sy, sz = half
    return np.array([[sx * a, sy * b, sz * c]
                     for a in (-1, 1) for b in (-1, 1) for c in (-1, 1)])


def build_robot_model(
    spec: RobotSpec,
    foot_sensor_map: dict[str, int] | None = None,
    contact_bodies: tuple[str, ...] | None = None,
) -> RobotModel:
    """Flatten a RobotSpec into a RobotModel.

    foot_sensor_map maps a *link name* (e.g. a cleat) to a foot-sensor slot
    0..7 in the reference layout (kick_env.py:467-478). Contact points derived
    from that link's collision boxes inherit the slot.

    contact_bodies optionally restricts ground-contact candidate points to the
    named movable bodies (after fixed-link merging); None = all bodies.
    """
    foot_sensor_map = foot_sensor_map or {}

    joints_by_child = {j.child: j for j in spec.joints}
    children = {}
    for j in spec.joints:
        children.setdefault(j.parent, []).append(j)

    root = spec.root_link()

    # DOF order: alphabetical movable joint names (Isaac Gym parity).
    movable = sorted((j for j in spec.joints if j.kind in _MOVABLE),
                     key=lambda j: j.name)
    nq = len(movable)
    joint_names = [j.name for j in movable]

    # Movable body list: root + child of each DOF.
    body_names = [root] + [j.child for j in movable]
    body_index = {n: i for i, n in enumerate(body_names)}
    nb = len(body_names)

    def movable_ancestor(link: str):
        """Walk up fixed joints: return (movable body idx, pos, rot) of link
        frame expressed in that ancestor's frame."""
        pos = np.zeros(3)
        rot = np.eye(3)
        while link not in body_index:
            j = joints_by_child[link]
            Rj = rpy_to_matrix(j.origin_rpy)
            pos = np.asarray(j.origin_xyz) + Rj @ pos
            rot = Rj @ rot
            link = j.parent
        return body_index[link], pos, rot

    # --- kinematics arrays --------------------------------------------------
    parent = np.full(nb, -1, dtype=np.int32)
    tree_pos = np.zeros((nb, 3))
    tree_rot = np.tile(np.eye(3), (nb, 1, 1))
    axis = np.zeros((nq, 3))
    lower = np.zeros(nq)
    upper = np.zeros(nq)
    effort = np.zeros(nq)
    velocity = np.zeros(nq)

    for d, j in enumerate(movable):
        b = d + 1
        pidx, p_off, p_rot = movable_ancestor(j.parent)
        Rj = rpy_to_matrix(j.origin_rpy)
        parent[b] = pidx
        tree_pos[b] = p_off + p_rot @ np.asarray(j.origin_xyz)
        tree_rot[b] = p_rot @ Rj
        ax = np.asarray(j.axis, dtype=float)
        axis[d] = ax / np.linalg.norm(ax)
        lower[d], upper[d] = j.lower, j.upper
        effort[d], velocity[d] = j.effort, j.velocity
        if parent[b] >= b:
            raise ValueError(f"joint order not topological at {j.name}")

    # --- mass properties: merge fixed subtrees into movable bodies ----------
    entries = [[] for _ in range(nb)]       # per movable body
    sites: dict[str, Site] = {}
    cpts, cbody, csens = [], [], []
    bx_body, bx_pos, bx_rot, bx_half = [], [], [], []

    # Bodies that carry dedicated sensor links (cleats): their own collision
    # boxes are excluded from ground-contact candidates so the (2 mm lower)
    # cleats carry the load, as they do under PhysX's rigid contacts.
    link_names = {l.name for l in spec.links}
    sensor_bodies = {movable_ancestor(l)[0]
                     for l in foot_sensor_map if l in link_names}

    for link in spec.links:
        b, off, rot = movable_ancestor(link.name)
        if link.name not in body_index:
            sites[link.name.lstrip("/")] = Site(body=b, pos=off, rot=rot)
        # inertial
        if link.mass > 0.0 or any(link.inertia):
            R_in = rot @ rpy_to_matrix(link.com_rpy)
            c_in = off + rot @ np.asarray(link.com_xyz)
            I_in = R_in @ _inertia_matrix(link.inertia) @ R_in.T
            entries[b].append((link.mass, c_in, I_in))
        # collision
        for g in link.collisions:
            Rg = rot @ rpy_to_matrix(g.origin_rpy)
            pg = off + rot @ np.asarray(g.origin_xyz)
            slot = foot_sensor_map.get(link.name, -1)
            if g.kind == "box":
                half = np.asarray(g.size) / 2.0
                bx_body.append(b); bx_pos.append(pg)
                bx_rot.append(Rg); bx_half.append(half)
                wanted = (contact_bodies is None
                          or body_names[b] in contact_bodies
                          or link.name in foot_sensor_map)
                shadowed = b in sensor_bodies and link.name not in foot_sensor_map
                if wanted and not shadowed:
                    for corner in _box_corners(half):
                        cpts.append(pg + Rg @ corner)
                        cbody.append(b)
                        csens.append(slot)
            elif g.kind == "sphere":
                if contact_bodies is None or body_names[b] in contact_bodies:
                    cpts.append(pg)
                    cbody.append(b)
                    csens.append(slot)

    mass = np.zeros(nb)
    com = np.zeros((nb, 3))
    inertia = np.zeros((nb, 3, 3))
    for b in range(nb):
        mass[b], com[b], inertia[b] = _compose_inertia(entries[b])

    return RobotModel(
        name=spec.name, nb=nb, nq=nq,
        parent=parent, tree_pos=tree_pos, tree_rot=tree_rot, axis=axis,
        mass=mass, com=com, inertia=inertia,
        dof_lower=lower, dof_upper=upper, dof_effort=effort,
        dof_velocity=velocity,
        joint_names=joint_names, body_names=body_names, sites=sites,
        cpoint_pos=np.asarray(cpts) if cpts else np.zeros((0, 3)),
        cpoint_body=np.asarray(cbody, dtype=np.int32) if cbody else np.zeros(0, np.int32),
        cpoint_sensor=np.asarray(csens, dtype=np.int32) if csens else np.zeros(0, np.int32),
        box_body=np.asarray(bx_body, dtype=np.int32) if bx_body else np.zeros(0, np.int32),
        box_pos=np.asarray(bx_pos) if bx_pos else np.zeros((0, 3)),
        box_rot=np.asarray(bx_rot) if bx_rot else np.zeros((0, 3, 3)),
        box_half=np.asarray(bx_half) if bx_half else np.zeros((0, 3)),
    )
