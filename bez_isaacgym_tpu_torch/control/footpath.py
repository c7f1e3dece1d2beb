"""Footstep timing, placement, and parabolic swing trajectories.

Semantics port of the reference Footpath
(resources/library/pycontrol/src/soccer_pycontrol/footpath.py): half/full
step timing (:28-36), pre/post ground-hold phase machine (:38-146), foot
placement at +-foot_separation (:148-160), which-foot-moves schedule
(:162-195), parabolic swing with Newton arc-length parameterization
(:229-295).
"""

from __future__ import annotations

import enum

import numpy as np

from bez_isaacgym_tpu_torch.control.path import Path
from bez_isaacgym_tpu_torch.control.transformation import Transformation


class PostPreSetting(enum.IntEnum):
    POST_AND_PRE = 0
    ONLY_POST_AND_PRE_ON_LAST_ONES = 1
    ONLY_POST = 2
    NO_POST_NOR_PRE = 3


def _hold_ratio(t: float, span: float, post: float, pre: float) -> float:
    """Swing ratio within one step window: 0 during post-hold, 1 during
    pre-hold, linear in between."""
    if t < post:
        return 0.0
    if t > span - pre:
        return 1.0
    return (t - post) / (span - post - pre)


class Footpath(Path):
    # footpath.py:17-22
    half_to_full_step_time_ratio = 0.7
    foot_separation = 0.044
    step_height = 0.065
    step_outwardness = 0.015
    step_rotation = 0.05

    first_step_left = 0   # set by Crotchpath

    def __init__(self, start_transform, end_transform,
                 foot_center_to_floor: float):
        super().__init__(start_transform, end_transform)
        self.foot_center_to_floor = foot_center_to_floor

    def num_steps(self) -> int:
        return self.body_step_count() + 1

    def full_step_time(self) -> float:
        return self.duration() / (2 * self.half_to_full_step_time_ratio
                                  + (self.num_steps() - 2))

    def half_step_time(self) -> float:
        return self.full_step_time() * self.half_to_full_step_time_ratio

    def foot_height_ratio(self, t: float, setting: int = 0):
        """[step_num, right_ratio, left_ratio] (footpath.py:38-146)."""
        full = self.full_step_time()
        half = self.half_step_time()
        post = self.post_footstep_ratio * full
        pre = self.pre_footstep_ratio * full
        if setting == PostPreSetting.ONLY_POST_AND_PRE_ON_LAST_ONES:
            if t < half:
                pre = 0.0
            elif t > self.duration() - half:
                post = 0.0
            else:
                post = pre = 0.0
        elif setting == PostPreSetting.ONLY_POST:
            pre = 0.0
            post = -post
        elif setting == PostPreSetting.NO_POST_NOR_PRE:
            post = pre = 0.0

        last_foot_same = self.num_steps() % 2
        step_num = -1

        def mid_ratio(parity: int):
            """Swing ratio in the mid-path full steps; updates step_num."""
            nonlocal step_num
            adj = t - half
            step_num = int(np.trunc(adj / full))
            adj -= step_num * full
            if step_num % 2 == parity:
                return 0.0
            return _hold_ratio(adj, full, post, pre)

        # First foot (swings during the initial half step).
        if t < half:
            first = _hold_ratio(t, half, post, pre)
        elif last_foot_same and t > self.duration() - half:
            first = _hold_ratio(t - (self.duration() - half), half, post, pre)
        else:
            first = mid_ratio(parity=0)

        # Second foot.
        if t < half:
            second = 0.0
        elif (not last_foot_same) and t > self.duration() - half:
            second = _hold_ratio(t - (self.duration() - half), half, post, pre)
        else:
            second = mid_ratio(parity=1)

        if self.first_step_left:
            right_ratio, left_ratio = first, second
        else:
            right_ratio, left_ratio = second, first
        return [step_num + 1, right_ratio, left_ratio]

    # -- foot placement ----------------------------------------------------
    def _foot_position_at_step(self, n: float, side: float) -> Transformation:
        """side=-1 right, +1 left (footpath.py:148-160)."""
        body = self.get_body_step(n)
        z = -body.get_position()[2] + self.foot_center_to_floor
        offset = Transformation([0.0, side * self.foot_separation, z])
        return body @ offset

    def right_foot_position_at_step(self, n) -> Transformation:
        return self._foot_position_at_step(n, -1.0)

    def left_foot_position_at_step(self, n) -> Transformation:
        return self._foot_position_at_step(n, +1.0)

    def what_is_the_foot_doing(self, step_num: int):
        """[right_action, left_action]: 1 body index = planted there, 2 =
        swinging between them (footpath.py:162-195).  NB the reference's
        `first_step_left=1` actually swings the RIGHT foot first — see
        footpath.py:165-171 and :133-138; reproduced as-is."""
        n = self.num_steps()
        if step_num == 0:
            moving, planted = [0, 1], [0]
            right_moves = bool(self.first_step_left)
        elif step_num == n - 1:
            moving, planted = [n - 2, n - 1], [n - 1]
            right_moves = bool(self.first_step_left) ^ (n % 2 == 0)
        else:
            moving = [step_num - 1, step_num + 1]
            planted = [step_num]
            if self.first_step_left:
                right_moves = step_num % 2 == 0
            else:
                right_moves = step_num % 2 != 0
        if right_moves:
            return [moving, planted]
        return [planted, moving]

    def foot_position(self, t: float):
        """[right_foot_T, left_foot_T] at time t (footpath.py:197-227)."""
        step_num, right_ratio, left_ratio = self.foot_height_ratio(t)
        right_action, left_action = self.what_is_the_foot_doing(step_num)

        if len(right_action) == 1:
            right = self.right_foot_position_at_step(right_action[0])
        else:
            right = self.parabolic_path(
                self.right_foot_position_at_step(right_action[0]),
                self.right_foot_position_at_step(right_action[1]),
                self.step_height, -self.step_outwardness,
                -self.step_rotation, right_ratio)
        if len(left_action) == 1:
            left = self.left_foot_position_at_step(left_action[0])
        else:
            left = self.parabolic_path(
                self.left_foot_position_at_step(left_action[0]),
                self.left_foot_position_at_step(left_action[1]),
                self.step_height, self.step_outwardness,
                self.step_rotation, left_ratio)
        return [right, left]

    # -- swing curve -------------------------------------------------------
    def parabolic_path(self, start: Transformation, end: Transformation,
                       zdiff: float, sidediff: float, rotdiff: float,
                       ratio: float, newton_iters: int = 20) -> Transformation:
        """Parabolic swing arc traversed at constant arc-length speed
        (footpath.py:229-295).  The Newton solve for the arc-length
        parameter runs a fixed iteration count (vectorization-friendly)
        instead of the reference's while loop (:255-262)."""
        step_time = self.body_step_time()
        dist = Transformation.distance(start, end)
        if dist == 0.0:
            # Degenerate in-place step: nudge the end 1 mm forward (:237-243).
            yaw = start.get_orientation_euler()[2]
            end = end.copy()
            end.set_position(end.get_position()
                             + np.array([np.cos(yaw), np.sin(yaw), 0.0]) * 1e-3)
            dist = Transformation.distance(start, end)

        h = float(np.linalg.norm([zdiff, sidediff]))
        a = dist / 2.0
        aa = 4.0 * h / dist

        # Newton: split the parabola at equal arc length.
        f = lambda x: x * np.sqrt(1.0 + x * x) + np.arcsinh(x)
        target = (1.0 - 2.0 * ratio) * f(aa)
        X = 0.0
        for _ in range(newton_iters):
            r = f(X) - target
            if abs(r) <= 1e-4:
                break
            X -= r / (2.0 * np.sqrt(1.0 + X * X))

        if aa == 0:
            d = ratio * dist
        else:
            d = 0.5 * (1.0 - X / aa) * dist

        time_ratio = np.clip((d / dist * step_time) / step_time, 0.0, 1.0) \
            if step_time > 0 else np.clip(ratio, 0.0, 1.0)
        base = Transformation.weighted_average(start, end, float(time_ratio))

        x = -a + d
        y = h * (1.0 - x * x / (a * a))
        lift_angle = np.arctan2(sidediff, zdiff)
        zdelta = np.cos(lift_angle) * y
        ydelta = np.sin(lift_angle) * y
        thetadelta = y / h * rotdiff if rotdiff != 0 else 0.0
        lift = Transformation(
            position=[0.0, ydelta, zdelta],
            quaternion=Transformation.quaternion_from_axis_angle(
                [1.0, 0.0, 0.0], thetadelta))
        return base @ lift
