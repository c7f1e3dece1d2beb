"""4x4 homogeneous transform helper (numpy), API parity with the reference
`Transformation` (resources/library/geometry/src/soccer_geometry/
transformation.py).

Composition-over-inheritance redesign: the reference subclasses np.ndarray;
we wrap a plain (4,4) array, which avoids the ndarray-subclass pitfalls while
keeping the same operations.  Euler orders follow the reference's scipy 'ZYX'
convention (index 0 = yaw).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation, Slerp


class Transformation:

    __slots__ = ("H",)

    def __init__(self, position=(0.0, 0.0, 0.0), quaternion=(0.0, 0.0, 0.0, 1.0),
                 matrix: np.ndarray | None = None):
        if matrix is not None:
            self.H = np.array(matrix, dtype=float)
        else:
            self.H = np.eye(4)
            self.set_position(position)
            self.set_orientation(quaternion)

    # -- accessors ----------------------------------------------------------
    def get_position(self) -> np.ndarray:
        return self.H[0:3, 3].copy()

    def set_position(self, position) -> None:
        self.H[0:3, 3] = position

    def get_orientation(self) -> np.ndarray:
        """xyzw quaternion."""
        return Rotation.from_matrix(self.H[0:3, 0:3]).as_quat()

    def set_orientation(self, quat) -> None:
        self.H[0:3, 0:3] = Rotation.from_quat(quat).as_matrix()

    def get_orientation_euler(self, seq: str = "ZYX") -> np.ndarray:
        """[yaw, pitch, roll] for the default ZYX order (reference parity)."""
        return Rotation.from_matrix(self.H[0:3, 0:3]).as_euler(seq)

    def rotation_matrix(self) -> np.ndarray:
        return self.H[0:3, 0:3].copy()

    # -- composition --------------------------------------------------------
    def __matmul__(self, other: "Transformation") -> "Transformation":
        return Transformation(matrix=self.H @ other.H)

    def inv(self) -> "Transformation":
        R = self.H[0:3, 0:3]
        p = self.H[0:3, 3]
        out = np.eye(4)
        out[0:3, 0:3] = R.T
        out[0:3, 3] = -R.T @ p
        return Transformation(matrix=out)

    def copy(self) -> "Transformation":
        return Transformation(matrix=self.H.copy())

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_dh(a: float, alpha: float, d: float, theta: float) -> "Transformation":
        """Standard DH convention (transformation.py:66-81 parity)."""
        ct, st = np.cos(theta), np.sin(theta)
        ca, sa = np.cos(alpha), np.sin(alpha)
        return Transformation(matrix=np.array([
            [ct, -st * ca, st * sa, a * ct],
            [st, ct * ca, -ct * sa, a * st],
            [0.0, sa, ca, d],
            [0.0, 0.0, 0.0, 1.0],
        ]))

    @staticmethod
    def from_euler(euler, seq: str = "ZYX", position=(0.0, 0.0, 0.0)) -> "Transformation":
        t = Transformation(position=position,
                           quaternion=Rotation.from_euler(seq, euler).as_quat())
        return t

    @staticmethod
    def from_xy_theta(x: float, y: float, theta: float) -> "Transformation":
        t = Transformation.from_euler([theta, 0.0, 0.0])
        t.set_position([x, y, 0.0])
        return t

    @staticmethod
    def quaternion_from_axis_angle(vector, angle: float) -> np.ndarray:
        v = np.asarray(vector, float)
        v = v / np.linalg.norm(v)
        return Rotation.from_rotvec(v * angle).as_quat()

    @staticmethod
    def axis_angle_from_quaternion(quaternion):
        rv = Rotation.from_quat(quaternion).as_rotvec()
        angle = float(np.linalg.norm(rv))
        vector = rv / angle if angle > 0 else np.array([0.0, 0.0, 1.0])
        return angle, vector

    # -- metrics / interpolation -------------------------------------------
    @staticmethod
    def distance(t1: "Transformation", t2: "Transformation") -> float:
        return float(np.linalg.norm(t1.H[0:3, 3] - t2.H[0:3, 3]))

    @staticmethod
    def weighted_average(t_start: "Transformation", t_end: "Transformation",
                         ratio: float) -> "Transformation":
        """Lerp position + slerp orientation (transformation.py:181-201)."""
        out = Transformation()
        p0, p1 = t_start.get_position(), t_end.get_position()
        out.set_position(p0 + (p1 - p0) * ratio)
        rots = Rotation.from_quat([t_start.get_orientation(),
                                   t_end.get_orientation()])
        out.set_orientation(Slerp([0, 1], rots)([ratio])[0].as_quat())
        return out
