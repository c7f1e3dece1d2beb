"""Closed-form 6-DOF leg inverse kinematics for the Bez humanoid.

Semantics port of the reference Soccerbot IK
(resources/library/pycontrol/src/soccer_pycontrol/soccerbot.py:190-251):
decompose the hip->foot transform into knee/ankle angles from the planar
2-link subproblem (thigh d3=0.089, calf d4=0.0827), then hip angles from the
residual ZYX rotation; left leg by mirror symmetry (:243-251).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation

from bez_isaacgym_tpu_torch.control.transformation import Transformation

# Link lengths from the reference constants table (soccerbot.py:85-88):
# right thigh->calf 0.089, calf->ankle 0.0827.
THIGH = 0.089
CALF = 0.0827

# DH table for the 6-DOF leg (soccerbot.py:117-124).
DH = np.array([
    [0.0, -np.pi / 2, 0.0, 0.0],
    [0.0, np.pi / 2, 0.0, 0.0],
    [THIGH, 0.0, 0.0, 0.0],
    [CALF, 0.0, 0.0, 0.0],
    [0.0, np.pi / 2, 0.0, 0.0],
    [0.0, 0.0, 0.0, 0.0],
])

TORSO_TO_RIGHT_HIP = np.array([0.0135, -0.035, -0.156])   # soccerbot.py:91-92
RIGHT_HIP_TO_LEFT_HIP = np.array([0.0, -0.07, 0.0])       # soccerbot.py:93-94


def ik_right_foot(transform: Transformation) -> list[float]:
    """Torso->right-foot transform -> 6 leg angles.

    Geometric derivation (same closed form as the reference IK,
    soccerbot.py:190-241, which any 6R leg with this DH table yields):

    1. Express the HIP position in the FOOT frame (invert the hip->foot
       transform): the ankle-roll axis (joint 6) must lie in the plane
       containing the hip, so theta6 = -atan2(y, z) of that vector.
    2. Rotating by theta6 reduces the chain to a planar 2-link problem
       (thigh d3, calf d4) in the foot's sagittal plane with coordinates
       (sagittal_x, sagittal_z): the law of cosines gives the knee angle
       via cos_knee = (|p|^2 - d3^2 - d4^2) / (2 d3 d4), taking the
       knee-backwards branch (negative sine).
    3. The ankle pitch follows from the triangle interior angles
       (alpha: hip elevation seen from the foot; beta: knee offset).
    4. The three hip angles come from the residual ZYX Euler rotation of
       H03 = T * R_final * H36^-1 once the distal DH links are removed.
    """
    T = transform.H.copy()
    T[0:3, 3] = T[0:3, 3] - TORSO_TO_RIGHT_HIP
    inv = np.linalg.inv(T)
    d3, d4 = DH[2, 0], DH[3, 0]
    hip_in_foot = inv[0:3, 3]

    reach = float(np.linalg.norm(hip_in_foot))
    if reach > d3 + d4:
        raise ValueError(f"IK position unreachable: {reach:.4f} > {d3 + d4:.4f}")

    # (1) ankle roll aligns the sagittal plane with the hip.
    theta6 = -np.arctan2(hip_in_foot[1], hip_in_foot[2])
    # (2) planar 2-link subproblem in the rotated sagittal plane.
    sagittal_z = hip_in_foot[2] / np.cos(theta6)
    sagittal_x = hip_in_foot[0]
    cos_knee = (sagittal_z ** 2 + sagittal_x ** 2
                - d3 ** 2 - d4 ** 2) / (2.0 * d3 * d4)
    knee = np.arctan2(cos_knee, -np.sqrt(max(1.0 - cos_knee ** 2, 0.0)))

    knee_wrapped = knee - np.pi / 2
    if knee_wrapped < 0:
        knee_wrapped = knee_wrapped + 2.0 * np.pi
    theta4 = -np.unwrap([knee_wrapped])[0]
    assert theta4 < 4.6

    # (3) ankle pitch from the triangle's interior angles.
    alpha = np.arctan2(sagittal_z, sagittal_x)
    beta = np.arctan2(-d3 * np.cos(knee), d4 + d3 * np.sin(knee))
    theta5 = np.pi / 2 - (alpha - beta)

    H34 = Transformation.from_dh(DH[3, 0], DH[3, 1], DH[3, 2], theta4)
    H45 = Transformation.from_dh(DH[4, 0], DH[4, 1], DH[4, 2], theta5)
    H56 = Transformation.from_dh(DH[5, 0], DH[5, 1], DH[5, 2], theta6)
    H36 = H34.H @ H45.H @ H56.H
    final_rotation = Transformation.from_euler([0.0, np.pi / 2, np.pi]).H
    H03 = T @ final_rotation @ np.linalg.inv(H36)
    assert np.linalg.norm(H03[0:3, 3]) - d3 < 0.03

    angles = Rotation.from_matrix(np.linalg.inv(H03[0:3, 0:3])).as_euler("ZYX")
    theta3 = np.pi / 2 - angles[0]
    theta1 = -angles[1]
    theta2 = angles[2] + np.pi / 2
    return [theta1, theta2, theta3, theta4, theta5, theta6]


def ik_left_foot(transform: Transformation) -> list[float]:
    """Left leg by mirror symmetry (soccerbot.py:243-251)."""
    T = transform.copy()
    T.H[0:3, 3] = T.H[0:3, 3] + RIGHT_HIP_TO_LEFT_HIP
    t1, t2, t3, t4, t5, t6 = ik_right_foot(T)
    return [-t1, -t2, t3, t4, t5, -t6]
