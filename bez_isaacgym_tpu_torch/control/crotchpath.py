"""Torso ("crotch") trajectory: body interpolation between footsteps plus
vertical/lateral sway.

Semantics port of the reference Crotchpath
(resources/library/pycontrol/src/soccer_pycontrol/crotchpath.py): first-step
foot selection (:21-28), body interpolation windows (:40-58), sinusoidal
vertical + parabolic lateral sway (:60-91).  Robotpath is the user-facing
facade (robotpath.py:13).
"""

from __future__ import annotations

import numpy as np

from bez_isaacgym_tpu_torch.control.footpath import Footpath, PostPreSetting
from bez_isaacgym_tpu_torch.control.transformation import Transformation


class Crotchpath(Footpath):
    # crotchpath.py:10-13
    crotch_zdiff_sway = 0.000
    crotch_sidediff_sway = -0.03
    crotch_thetadiff_sway = (0.0, 0.0, 0.0)

    def __init__(self, start_transform, end_transform, foot_center_to_floor):
        super().__init__(start_transform, end_transform, foot_center_to_floor)
        # First-step foot from the bearing to the goal (crotchpath.py:21-28).
        angle, _ = Transformation.axis_angle_from_quaternion(
            self.start_transform.get_orientation())
        diff = end_transform.H @ np.linalg.inv(start_transform.H)
        theta2 = np.arctan2(diff[1, 3], diff[0, 3])
        if (theta2 - angle) % (2.0 * np.pi) > np.pi:
            self.first_step_left = 0
        else:
            self.first_step_left = 1

    def crotch_position(self, t: float) -> Transformation:
        step_num, right_ratio, left_ratio = self.foot_height_ratio(
            t, PostPreSetting.ONLY_POST_AND_PRE_ON_LAST_ONES)
        right_action, _ = self.what_is_the_foot_doing(step_num)
        right_moving = len(right_action) == 2
        ratio = right_ratio if right_moving else left_ratio

        # Base interpolation between body steps (crotchpath.py:40-58).
        if step_num == 0:
            a, b = self.get_body_step(0), self.get_body_step(1)
            body_ratio = ratio / 2.0
        elif step_num == self.num_steps() - 1:
            a, b = self.get_body_step(step_num - 1), self.get_body_step(step_num)
            body_ratio = ratio / 2.0 + 0.5
        elif ratio < 0.5:
            a, b = self.get_body_step(step_num - 1), self.get_body_step(step_num)
            body_ratio = ratio + 0.5
        else:
            a, b = self.get_body_step(step_num), self.get_body_step(step_num + 1)
            body_ratio = ratio - 0.5
        position = self.parabolic_path(a, b, 0.0, 0.0, 0.0, body_ratio)

        # Sway uses no-hold ratios (crotchpath.py:60-87).
        _, right_nr, left_nr = self.foot_height_ratio(
            t, PostPreSetting.NO_POST_NOR_PRE)
        ratio = right_nr if right_moving else left_nr
        if t < self.half_step_time():
            zdiff = self.crotch_zdiff_sway * (1.0 - np.cos(ratio * np.pi))
        elif t > self.duration() - self.half_step_time():
            zdiff = self.crotch_zdiff_sway * (1.0 - np.cos(ratio * np.pi + np.pi))
        else:
            zdiff = self.crotch_zdiff_sway * (1.0 - np.cos(ratio * 2.0 * np.pi + np.pi))

        is_right_foot = -1.0 if right_moving else 1.0
        r = -4.0 * ratio * ratio + 4.0 * ratio
        ydiff = r * self.crotch_sidediff_sway * is_right_foot
        thetadiff = ydiff / self.crotch_sidediff_sway * \
            np.asarray(self.crotch_thetadiff_sway)

        sway = Transformation.from_euler(thetadiff)
        sway.set_position([-0.005, ydiff, zdiff])
        return position @ sway


class Robotpath(Crotchpath):
    """User-facing path facade (robotpath.py:13; debug plotting omitted)."""

    def foot_position(self, t: float):
        return super().foot_position(t)
