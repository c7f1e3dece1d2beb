"""The port's camera model (control/camera.py) against the JAX package's:
projection, its round trip through the floor intersection, and the rays,
for cameras at poses drawn with numpy from a seed."""

import numpy as np
import pytest

pytest.importorskip("torch")

from bez_isaacgym_tpu.control.camera import Camera as JCamera  # noqa: E402
from bez_isaacgym_tpu.control.transformation import \
    Transformation as JTransformation  # noqa: E402
from bez_isaacgym_tpu_torch.control.camera import Camera  # noqa: E402
from bez_isaacgym_tpu_torch.control.transformation import \
    Transformation  # noqa: E402


def test_camera_projection_roundtrip():
    """tests/test_viz_misc.py's round trip, on the port's camera."""
    cam = Camera(Transformation(position=[0, 0, 0.5]))
    px = cam.world_to_pixel([2.0, 0.0, 0.5])
    np.testing.assert_allclose(px, [320, 240], atol=1e-6)
    assert cam.world_to_pixel([-1.0, 0.0, 0.5]) is None
    ground = cam.find_floor_coordinate(320, 400)
    assert ground is not None
    assert ground[0] > 0 and abs(ground[2]) < 1e-9
    np.testing.assert_allclose(cam.world_to_pixel(ground), [320, 400],
                               atol=1e-4)


def _pair(rng):
    """The same pose (a head-height camera pitched down, yawed) as a port
    and a JAX camera."""
    from scipy.spatial.transform import Rotation

    pos = [rng.uniform(-1, 1), rng.uniform(-1, 1), rng.uniform(0.3, 0.6)]
    yaw, pitch, roll = (rng.uniform(-np.pi, np.pi), rng.uniform(0.1, 0.8),
                        rng.uniform(-0.3, 0.3))
    quat = Rotation.from_euler("ZYX", [yaw, pitch, roll]).as_quat()
    fov = rng.uniform(1.0, 1.6)
    return (Camera(Transformation(position=pos, quaternion=quat),
                   horizontal_fov=fov),
            JCamera(JTransformation(position=pos, quaternion=quat),
                    horizontal_fov=fov))


@pytest.mark.parametrize("seed", range(4))
def test_camera_equals_jax(seed):
    rng = np.random.default_rng(seed)
    cam, jcam = _pair(rng)
    assert cam.focal_px == jcam.focal_px
    assert cam.vertical_fov == jcam.vertical_fov
    hits = 0
    for _ in range(16):
        u, v = rng.uniform(0, 640), rng.uniform(0, 480)
        np.testing.assert_array_equal(cam.pixel_to_ray(u, v),
                                      jcam.pixel_to_ray(u, v))
        ground = cam.find_floor_coordinate(u, v)
        want = jcam.find_floor_coordinate(u, v)
        assert (ground is None) == (want is None)
        if ground is None:
            continue
        hits += 1
        np.testing.assert_array_equal(ground, want)
        assert abs(ground[2]) < 1e-9
        # Floor point -> pixel: the same pixel back, in both.
        np.testing.assert_allclose(cam.world_to_pixel(ground), [u, v],
                                   atol=1e-6)
        np.testing.assert_array_equal(cam.world_to_pixel(ground),
                                      jcam.world_to_pixel(ground))
    assert hits > 0
    behind = cam.pose.get_position() - 2.0 * (
        cam.pose.rotation_matrix() @ np.array([1.0, 0.0, 0.0]))
    assert cam.world_to_pixel(behind) is None
    assert jcam.world_to_pixel(behind) is None
