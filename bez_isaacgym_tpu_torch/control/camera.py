"""Camera geometry utilities (reference parity: soccer_geometry/camera.py,
de-ROS-ified).

The reference's Camera wraps ROS transforms and camera-info messages; ours
is a plain pinhole model on our Transformation class — pose on the robot's
head (the `camera` site in the model), FOV/resolution, world<->pixel
projection.
"""

from __future__ import annotations

import numpy as np

from bez_isaacgym_tpu_torch.control.transformation import Transformation


class Camera:
    """Pinhole camera rigidly mounted at a pose.

    Defaults mirror the reference's camera geometry (diagonal FOV 1.39626
    rad, 640x480: camera.py constants).
    """

    def __init__(self, pose: Transformation | None = None,
                 horizontal_fov: float = 1.39626,
                 width: int = 640, height: int = 480):
        self.pose = pose or Transformation()
        self.horizontal_fov = horizontal_fov
        self.width = width
        self.height = height

    @property
    def vertical_fov(self) -> float:
        return self.horizontal_fov * self.height / self.width

    @property
    def focal_px(self) -> float:
        return (self.width / 2.0) / np.tan(self.horizontal_fov / 2.0)

    def world_to_pixel(self, point_world) -> np.ndarray | None:
        """Project a world point to pixel coordinates; None if behind."""
        p = self.pose.inv().H @ np.append(np.asarray(point_world, float), 1.0)
        # Camera looks along +x with +z up, +y left (robot convention).
        if p[0] <= 0:
            return None
        u = self.width / 2.0 - self.focal_px * (p[1] / p[0])
        v = self.height / 2.0 - self.focal_px * (p[2] / p[0])
        return np.array([u, v])

    def pixel_to_ray(self, u: float, v: float) -> np.ndarray:
        """Unit ray direction in world frame through pixel (u, v)."""
        d = np.array([
            1.0,
            (self.width / 2.0 - u) / self.focal_px,
            (self.height / 2.0 - v) / self.focal_px,
        ])
        d /= np.linalg.norm(d)
        return self.pose.rotation_matrix() @ d

    def find_floor_coordinate(self, u: float, v: float) -> np.ndarray | None:
        """Intersect the pixel ray with the z=0 ground plane
        (camera.py findFloorCoordinate parity)."""
        origin = self.pose.get_position()
        ray = self.pixel_to_ray(u, v)
        if ray[2] >= -1e-9:
            return None
        t = -origin[2] / ray[2]
        return origin + t * ray
