"""RobotSpec: a plain-python robot description, loaded from the JSON asset
(`portbench/reference/assets/bez_stl.json`); it feeds
:mod:`portbench.reference.models.robot`, which flattens it into the arrays
the physics step consumes.  (The port also parses URDF XML; the reference
loads only the JSON asset, so the copy leaves the parser out.)
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np


def rpy_to_matrix(rpy) -> np.ndarray:
    """URDF fixed-axis rpy -> rotation matrix (R = Rz(y) @ Ry(p) @ Rx(r))."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


@dataclass
class GeomSpec:
    """One collision geometry attached to a link."""

    kind: str                 # "box" | "sphere" | "cylinder" | "mesh"
    origin_xyz: list[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    origin_rpy: list[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    size: list[float] = field(default_factory=list)   # box: [lx,ly,lz]; sphere: [r]; cylinder: [r, l]
    mesh: str = ""


@dataclass
class LinkSpec:
    name: str
    mass: float = 0.0
    com_xyz: list[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    com_rpy: list[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    # Inertia about COM in the inertial frame: [ixx, ixy, ixz, iyy, iyz, izz]
    inertia: list[float] = field(default_factory=lambda: [0.0] * 6)
    collisions: list[GeomSpec] = field(default_factory=list)


@dataclass
class JointSpec:
    name: str
    kind: str                 # "revolute" | "fixed" | "continuous" | "prismatic" | "floating"
    parent: str
    child: str
    origin_xyz: list[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    origin_rpy: list[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    axis: list[float] = field(default_factory=lambda: [1.0, 0.0, 0.0])
    lower: float = 0.0
    upper: float = 0.0
    effort: float = 0.0
    velocity: float = 0.0


@dataclass
class RobotSpec:
    name: str
    links: list[LinkSpec] = field(default_factory=list)
    joints: list[JointSpec] = field(default_factory=list)

    def link(self, name: str) -> LinkSpec:
        for l in self.links:
            if l.name == name:
                return l
        raise KeyError(name)

    def root_link(self) -> str:
        children = {j.child for j in self.joints}
        roots = [l.name for l in self.links if l.name not in children]
        if len(roots) != 1:
            raise ValueError(f"expected one root link, got {roots}")
        return roots[0]

    # -- JSON loading (the on-disk asset format) ---------------------------
    @staticmethod
    def from_json(s: str) -> "RobotSpec":
        d = json.loads(s)
        links = [
            LinkSpec(
                name=l["name"], mass=l["mass"], com_xyz=l["com_xyz"],
                com_rpy=l["com_rpy"], inertia=l["inertia"],
                collisions=[GeomSpec(**g) for g in l["collisions"]],
            )
            for l in d["links"]
        ]
        joints = [JointSpec(**j) for j in d["joints"]]
        return RobotSpec(name=d["name"], links=links, joints=joints)
