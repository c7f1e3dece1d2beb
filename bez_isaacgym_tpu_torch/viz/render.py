"""Stick-figure and visual-mesh episode renderer from FK (headless).

Port of `bez_isaacgym_tpu/viz/render.py` (the reference relies on the
Isaac Gym viewer, vec_task.py:197-224; camera config bez_kick.yaml:110-113):
matplotlib 3D frames from the port's forward kinematics, written as PNG
frames or an animated GIF.

    from bez_isaacgym_tpu_torch.viz.render import render_frame, render_episode
    render_episode(model, list_of_physics_states, "episode.gif")

A state is one env's `PhysicsState` (tensors on any device, or numpy
arrays): the kinematics run on the state's device and the geometry goes to
matplotlib as numpy.  matplotlib is imported only where a figure is drawn,
so the geometry works without it; `require_matplotlib` raises a clear
`ImportError` where it is missing.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from bez_isaacgym_tpu_torch.models.robot import RobotModel
from bez_isaacgym_tpu_torch.ops import kinematics as kin

MESHES_PATH = Path(__file__).resolve().parents[1] / "assets" / "meshes.npz"


def require_matplotlib():
    """The matplotlib module (Agg backend); raises an ImportError naming
    matplotlib when it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("rendering needs matplotlib, which is not "
                          "installed; install it, or play without "
                          "render=") from e
    matplotlib.use("Agg")
    return matplotlib


def _frames(model: RobotModel, physics) -> kin.BodyFrames:
    """Forward kinematics of one env on its state's device (f32)."""
    q = torch.as_tensor(physics.q, dtype=torch.float32)
    dev = q.device

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    with torch.no_grad():
        return kin.forward_kinematics(model, q, t(physics.base_pos),
                                      t(physics.base_quat))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _skeleton(model: RobotModel, physics) -> np.ndarray:
    """(n_edges, 2, 3) world-space segments parent-com -> child-com."""
    com = _np(_frames(model, physics).com)
    return np.asarray([[com[int(model.parent[b])], com[b]]
                       for b in range(1, model.nb)])


_MESHES = None


def _load_meshes() -> dict:
    """Decimated visual meshes (the port's copy of assets/meshes.npz):
    {link_name: (verts (V,3) link-frame, faces (F,3))}; {} if absent."""
    global _MESHES
    if _MESHES is None:
        if not MESHES_PATH.exists():
            _MESHES = {}
        else:
            z = np.load(MESHES_PATH)
            names = sorted({k.rsplit(":", 1)[0] for k in z.files})
            _MESHES = {n: (z[f"{n}:verts"], z[f"{n}:faces"]) for n in names}
    return _MESHES


def _mesh_polys_world(model: RobotModel, physics):
    """(tri_list, shade): world-space visual-mesh triangles and flat
    shading (the decimated copies of the URDF's visual meshes through the
    port's FK, lit by a fixed directional lambert)."""
    meshes = _load_meshes()
    if not meshes:
        return [], []
    frames = _frames(model, physics)
    rot, pos = _np(frames.rot), _np(frames.pos)
    light = np.array([0.45, 0.3, 0.85])
    light /= np.linalg.norm(light)
    tris, shade = [], []
    for name, (verts, faces) in meshes.items():
        if name not in model.body_names:
            continue          # fixed link merged away in this variant
        b = model.body_index(name)
        w = verts @ rot[b].T + pos[b]
        t = w[faces]                                   # (F, 3, 3)
        n = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
        n /= np.linalg.norm(n, axis=1, keepdims=True) + 1e-12
        tris.append(t)
        shade.append(0.35 + 0.65 * np.abs(n @ light))
    return (list(np.concatenate(tris, 0)) if tris else [],
            np.concatenate(shade, 0) if shade else [])


_CORNER_SIGNS = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                          for sz in (-1, 1)], np.float64)
# Quad faces of a unit box in _CORNER_SIGNS index order.
_BOX_FACES = [(0, 1, 3, 2), (4, 5, 7, 6), (0, 1, 5, 4),
              (2, 3, 7, 6), (0, 2, 6, 4), (1, 3, 7, 5)]


def _box_faces_world(model: RobotModel, physics) -> list:
    """World-space quad faces of the URDF collision boxes (the silhouette
    for variants without visual meshes)."""
    frames = _frames(model, physics)
    rot, pos = _np(frames.rot), _np(frames.pos)
    faces = []
    for i in range(len(model.box_body)):
        b = int(model.box_body[i])
        Rw = rot[b] @ model.box_rot[i]
        ow = pos[b] + rot[b] @ model.box_pos[i]
        corners = ow + (_CORNER_SIGNS * model.box_half[i]) @ Rw.T
        faces.extend(corners[list(f)] for f in _BOX_FACES)
    return faces


def render_frame(model: RobotModel, physics, ax=None, ball: bool = True,
                 boxes: bool = True, meshes: bool = True,
                 lims=((-0.5, 1.5), (-0.75, 0.75), (0.0, 0.8))):
    """Draw one frame; returns the matplotlib axis.  meshes=True draws the
    visual meshes where this model's links have them; the collision boxes
    are the silhouette otherwise."""
    require_matplotlib()
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    if ax is None:
        fig = plt.figure(figsize=(6, 5))
        ax = fig.add_subplot(111, projection="3d")
    drew_mesh = False
    if meshes:
        tris, shade = _mesh_polys_world(model, physics)
        if tris:
            base = np.array([0.19, 0.42, 0.74])
            cols = np.clip(shade[:, None] * base[None], 0, 1)
            ax.add_collection3d(Poly3DCollection(
                tris, facecolors=cols, edgecolors="none"))
            drew_mesh = True
    if boxes and not drew_mesh and len(model.box_body):
        ax.add_collection3d(Poly3DCollection(
            _box_faces_world(model, physics), facecolors="tab:blue",
            edgecolors="none", alpha=0.18))
    if not drew_mesh:
        for a, b in _skeleton(model, physics):
            ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], "o-",
                    color="tab:blue", markersize=2, linewidth=1.5)
    if ball:
        bp = _np(physics.ball_pos)
        ax.scatter([bp[0]], [bp[1]], [bp[2]], s=80, color="tab:orange")
    ax.set_xlim(*lims[0])
    ax.set_ylim(*lims[1])
    ax.set_zlim(*lims[2])
    ax.set_box_aspect((lims[0][1] - lims[0][0], lims[1][1] - lims[1][0],
                       lims[2][1] - lims[2][0]))
    return ax


def render_episode(model: RobotModel, states: list, path: str,
                   every: int = 2, fps: int = 30, ball: bool = True) -> str:
    """Render a list of PhysicsState frames to a GIF (Pillow) or another
    format matplotlib's writers know, at `path`."""
    require_matplotlib()
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    frames = states[::every]
    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(111, projection="3d")

    def update(i):
        ax.cla()
        render_frame(model, frames[i], ax=ax, ball=ball)
        ax.set_title(f"t = {i * every / 60:.2f} s")
        return []

    anim = FuncAnimation(fig, update, frames=len(frames))
    if path.endswith(".gif"):
        anim.save(path, writer=PillowWriter(fps=fps))
    else:
        anim.save(path, fps=fps)
    plt.close(fig)
    return path
