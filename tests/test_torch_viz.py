"""The port's visualization layer (`bez_isaacgym_tpu_torch/viz/`) against
the JAX package's `viz/` on the CPU.

- `_skeleton`, `_mesh_polys_world` and `_box_faces_world` from the same
  states (the ready pose and randomly posed, tilted robots) equal the JAX
  ones to 1e-5 m (the same f32 forward kinematics), and each triangle's
  flat shade within what its vertices' difference turns its normal by;
- `render_frame` writes a PNG, `render_episode` a GIF, for the `stl` model
  (visual meshes) and the `box` model (collision boxes and skeleton);
- the `LiveViewer` serves its page and JPEG frames on localhost and maps
  ESC / V / SPACE / R onto its flags;
- `KickRewardDebugger`'s histories from the same kick states equal the JAX
  debugger's to 1e-5, and it saves its grid;
- the runner's render path writes env 0's episode as a GIF on the CPU.
"""

import os
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
pytest.importorskip("matplotlib")

import jax  # noqa: E402

import torch_ppo_parity as P  # noqa: E402
from bez_isaacgym_tpu.models import bez as jbez  # noqa: E402
from bez_isaacgym_tpu.ops import engine as jengine  # noqa: E402
from bez_isaacgym_tpu.viz import debug_rewards as jdebug  # noqa: E402
from bez_isaacgym_tpu.viz import render as jrender  # noqa: E402
from bez_isaacgym_tpu_torch.models import bez  # noqa: E402
from bez_isaacgym_tpu_torch.ops import engine  # noqa: E402
from bez_isaacgym_tpu_torch.rl.runner import Runner  # noqa: E402
from bez_isaacgym_tpu_torch.utils import config as tconfig  # noqa: E402
from bez_isaacgym_tpu_torch.viz import debug_rewards, render  # noqa: E402
from bez_isaacgym_tpu_torch.viz.live import LiveViewer  # noqa: E402


def _poses(model, n=3):
    """The ready pose, then n random poses with tilted bases (numpy)."""
    rng = np.random.default_rng(0)
    q0 = bez.pose_vector(model, bez.READY_JOINT_ANGLES).astype(np.float32)
    out = [(q0, np.array([0, 0, 0.34], np.float32),
            np.array([0, 0, 0, 1], np.float32))]
    for _ in range(n):
        quat = rng.standard_normal(4).astype(np.float32)
        quat[3] += 4.0
        out.append(((q0 + rng.uniform(-0.5, 0.5, q0.shape)).astype(
            np.float32), rng.uniform(-0.3, 0.3, 3).astype(np.float32),
            (quat / np.linalg.norm(quat)).astype(np.float32)))
    return out


def _states(variant):
    """(JAX state, port state) pairs of one env at each pose."""
    jm, tm = jbez.load_bez_model(variant), bez.load_bez_model(variant)
    pairs = []
    for q, pos, quat in _poses(tm):
        js = jengine.default_state(jm, jengine.SceneConfig(), q, pos, quat)
        ts = engine.default_state(tm, engine.SceneConfig(),
                                  torch.as_tensor(q), pos, quat)
        pairs.append((js, ts))
    return jm, tm, pairs


@pytest.mark.parametrize("variant", ["stl", "box"])
def test_geometry_equals_jax(variant):
    jm, tm, pairs = _states(variant)
    for js, ts in pairs:
        P.assert_close(render._skeleton(tm, ts), jrender._skeleton(jm, js),
                       0, 1e-5, "skeleton")
        faces = render._box_faces_world(tm, ts)
        assert len(faces) == 6 * len(tm.box_body)
        P.assert_close(np.stack(faces), np.stack(jrender._box_faces_world(
            jm, js)), 0, 1e-5, "collision boxes")
        tris, shade = render._mesh_polys_world(tm, ts)
        jtris, jshade = jrender._mesh_polys_world(jm, js)
        assert len(tris) == len(jtris) and (variant == "box" or
                                            len(tris) > 1000)
        if tris:
            t, jt = np.stack(tris), np.stack(jtris).astype(np.float64)
            P.assert_close(t, jt, 0, 1e-5, "mesh")
            # A flat shade follows the triangle's unit normal, which a
            # vertex error dv turns by up to about 2 dv |edge| / |e1 x e2|:
            # a sliver triangle's shade moves far more than its vertices.
            dv = float(np.abs(t - jt).max())
            e1, e2 = jt[:, 1] - jt[:, 0], jt[:, 2] - jt[:, 0]
            edge = np.maximum(np.linalg.norm(e1, axis=1),
                              np.linalg.norm(e2, axis=1))
            area2 = np.linalg.norm(np.cross(e1, e2), axis=1)
            # (A zero-area triangle has no normal: its shade is free.)
            turn = np.divide(4 * dv * edge, area2,
                             out=np.full_like(area2, np.inf),
                             where=area2 > 0)
            assert (np.abs(shade - jshade) <= 1e-6 + turn).all()


def test_meshes_are_the_jax_package_assets():
    a = np.load(render.MESHES_PATH)
    b = np.load(os.path.join(os.path.dirname(jrender.__file__), "..",
                             "assets", "meshes.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("variant", ["stl", "box"])
def test_render_frame_and_episode(tmp_path, variant):
    _, tm, pairs = _states(variant)
    ts = pairs[0][1]
    ax = render.render_frame(tm, ts)
    png = tmp_path / "frame.png"
    ax.figure.savefig(png)
    assert png.stat().st_size > 1000
    out = render.render_episode(tm, [p[1] for p in pairs],
                                str(tmp_path / "ep.gif"), every=1)
    assert os.path.getsize(out) > 1000


def test_live_viewer_stream_and_keys():
    _, tm, pairs = _states("stl")
    viewer = LiveViewer(port=0, quiet=True, fps=1000.0)
    base = f"http://localhost:{viewer.port}"
    try:
        assert b"live viewer" in urllib.request.urlopen(f"{base}/",
                                                         timeout=5).read()
        assert viewer.publish(tm, pairs[0][1], extra_title="t=0", reward=1.0)
        assert urllib.request.urlopen(f"{base}/frame",
                                      timeout=5).read()[:2] == b"\xff\xd8"

        def press(k):
            urllib.request.urlopen(urllib.request.Request(
                f"{base}/key?k={k}", method="POST"), timeout=5)

        press("sync")
        assert viewer.enable_viewer_sync is False
        assert viewer.publish(tm, pairs[0][1]) is False
        press("pause")
        assert viewer.paused is True
        press("pause")
        assert viewer.paused is False
        press("reset")
        assert viewer.pop_reset() is True and viewer.pop_reset() is False
        press("quit")
        assert viewer.quit_requested is True
    finally:
        viewer.close()


def test_kick_reward_debugger_equals_jax(tmp_path):
    jtask, ttask = P.tasks()
    (jst, _), (tst, _), _ = P.start(jtask, {}, 2)
    # A second state: the ball moved and time passed.
    jst2 = jst._replace(progress=jst.progress + 30,
                        physics=jst.physics._replace(
                            ball_pos=jst.physics.ball_pos + np.array(
                                [0.4, 0.1, 0.0], np.float32)))
    tst2 = P.convert.env_state(P.np_tree(jst2))
    jd, td = jdebug.KickRewardDebugger(jtask), \
        debug_rewards.KickRewardDebugger(ttask)
    for js, ts in ((jst, tst), (jst2, tst2)):
        jd.record(jax.tree.map(jax.numpy.asarray, js))
        td.record(ts)
    assert td.t == jd.t == [0, 30]
    for f in td.FIELDS:
        P.assert_close(td.history[f], jd.history[f], 1e-5, 1e-6, f)
    assert td.history["distance_kicked"][1] > 0.4
    assert os.path.getsize(td.save(str(tmp_path / "rewards.png"))) > 1000


def test_runner_render_path_writes_the_episode(tmp_path):
    out = tmp_path / "episode.gif"
    runner = Runner(tconfig.parse_overrides([
        "num_envs=2", "train.units=[16,16]", "task_cfg.substeps=1",
        "device=cpu", "test=True", f"render={out}",
        f"output_dir={tmp_path}"]))
    runner.play(4)
    assert runner.played["steps"] == 4
    assert out.stat().st_size > 1000
