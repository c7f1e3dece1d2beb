"""URDF -> RobotSpec: a plain-python robot description.

Replacement for Isaac Gym's closed-source URDF importer
(`gym.load_asset`, used at bez_isaacgym/tasks/kick_env.py:302).
The parser is host-side (numpy only); the output feeds
:mod:`bez_isaacgym_tpu_torch.models.robot` which flattens it into arrays the
physics step consumes.

Specs can also be loaded/saved as JSON (our canonical asset format), so the
shipped Bez models do not depend on URDF files at runtime.
"""

from __future__ import annotations

import json
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field, asdict

import numpy as np


def _floats(s: str | None, default=(0.0, 0.0, 0.0)) -> list[float]:
    if s is None:
        return list(default)
    return [float(x) for x in s.split()]


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

    # -- URDF export ---------------------------------------------------------
    def to_urdf(self) -> str:
        """Emit URDF XML (for interop and the native compiler round-trip)."""
        out = ['<?xml version="1.0"?>', f'<robot name="{self.name}">']
        for l in self.links:
            out.append(f'  <link name="{l.name}">')
            out.append('    <inertial>')
            out.append(f'      <origin xyz="{l.com_xyz[0]} {l.com_xyz[1]} '
                       f'{l.com_xyz[2]}" rpy="{l.com_rpy[0]} {l.com_rpy[1]} '
                       f'{l.com_rpy[2]}"/>')
            out.append(f'      <mass value="{l.mass}"/>')
            i = l.inertia
            out.append(f'      <inertia ixx="{i[0]}" ixy="{i[1]}" ixz="{i[2]}"'
                       f' iyy="{i[3]}" iyz="{i[4]}" izz="{i[5]}"/>')
            out.append('    </inertial>')
            for g in l.collisions:
                out.append('    <collision>')
                out.append(f'      <origin xyz="{g.origin_xyz[0]} '
                           f'{g.origin_xyz[1]} {g.origin_xyz[2]}" '
                           f'rpy="{g.origin_rpy[0]} {g.origin_rpy[1]} '
                           f'{g.origin_rpy[2]}"/>')
                out.append('      <geometry>')
                if g.kind == "box":
                    out.append(f'        <box size="{g.size[0]} {g.size[1]} '
                               f'{g.size[2]}"/>')
                elif g.kind == "sphere":
                    out.append(f'        <sphere radius="{g.size[0]}"/>')
                elif g.kind == "cylinder":
                    out.append(f'        <cylinder radius="{g.size[0]}" '
                               f'length="{g.size[1]}"/>')
                elif g.kind == "mesh":
                    out.append(f'        <mesh filename="{g.mesh}"/>')
                out.append('      </geometry>')
                out.append('    </collision>')
            out.append('  </link>')
        for j in self.joints:
            out.append(f'  <joint name="{j.name}" type="{j.kind}">')
            out.append(f'    <parent link="{j.parent}"/>')
            out.append(f'    <child link="{j.child}"/>')
            out.append(f'    <origin xyz="{j.origin_xyz[0]} {j.origin_xyz[1]} '
                       f'{j.origin_xyz[2]}" rpy="{j.origin_rpy[0]} '
                       f'{j.origin_rpy[1]} {j.origin_rpy[2]}"/>')
            out.append(f'    <axis xyz="{j.axis[0]} {j.axis[1]} {j.axis[2]}"/>')
            out.append(f'    <limit lower="{j.lower}" upper="{j.upper}" '
                       f'effort="{j.effort}" velocity="{j.velocity}"/>')
            out.append('  </joint>')
        out.append('</robot>')
        return "\n".join(out)

    # -- JSON round-trip (canonical on-disk asset format) --------------------
    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=1)

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


def parse_urdf(path_or_text: str) -> RobotSpec:
    """Parse a URDF file path or XML string into a RobotSpec."""
    if path_or_text.lstrip().startswith("<"):
        root = ET.fromstring(path_or_text)
    else:
        root = ET.parse(path_or_text).getroot()

    spec = RobotSpec(name=root.get("name", "robot"))

    for le in root.findall("link"):
        link = LinkSpec(name=le.get("name"))
        inert = le.find("inertial")
        if inert is not None:
            o = inert.find("origin")
            if o is not None:
                link.com_xyz = _floats(o.get("xyz"))
                link.com_rpy = _floats(o.get("rpy"))
            m = inert.find("mass")
            if m is not None:
                link.mass = float(m.get("value"))
            ie = inert.find("inertia")
            if ie is not None:
                link.inertia = [float(ie.get(k, "0")) for k in
                                ("ixx", "ixy", "ixz", "iyy", "iyz", "izz")]
        for ce in le.findall("collision"):
            g = GeomSpec(kind="mesh")
            o = ce.find("origin")
            if o is not None:
                g.origin_xyz = _floats(o.get("xyz"))
                g.origin_rpy = _floats(o.get("rpy"))
            ge = ce.find("geometry")
            if ge is not None:
                box = ge.find("box")
                sph = ge.find("sphere")
                cyl = ge.find("cylinder")
                mesh = ge.find("mesh")
                if box is not None:
                    g.kind, g.size = "box", _floats(box.get("size"))
                elif sph is not None:
                    g.kind, g.size = "sphere", [float(sph.get("radius"))]
                elif cyl is not None:
                    g.kind = "cylinder"
                    g.size = [float(cyl.get("radius")), float(cyl.get("length"))]
                elif mesh is not None:
                    g.kind, g.mesh = "mesh", mesh.get("filename", "")
            link.collisions.append(g)
        spec.links.append(link)

    for je in root.findall("joint"):
        j = JointSpec(
            name=je.get("name"),
            kind=je.get("type", "fixed"),
            parent=je.find("parent").get("link"),
            child=je.find("child").get("link"),
        )
        o = je.find("origin")
        if o is not None:
            j.origin_xyz = _floats(o.get("xyz"))
            j.origin_rpy = _floats(o.get("rpy"))
        a = je.find("axis")
        if a is not None:
            j.axis = _floats(a.get("xyz"), default=(1.0, 0.0, 0.0))
        lim = je.find("limit")
        if lim is not None:
            j.lower = float(lim.get("lower", "0"))
            j.upper = float(lim.get("upper", "0"))
            j.effort = float(lim.get("effort", "0"))
            j.velocity = float(lim.get("velocity", "0"))
        spec.joints.append(j)

    return spec
