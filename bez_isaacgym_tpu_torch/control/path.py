"""Body-pose path planning: cubic Bezier or 3-phase rotate-in-place.

Semantics port of the reference Path
(resources/library/pycontrol/src/soccer_pycontrol/path.py): constants
(:20-29), arc-length distance map (:36-53), step-size rounding (:55-69),
rotate-in-place mode for short paths (:140-206), Bezier profile (:208-233),
walking-backwards detection (:125-136).
"""

from __future__ import annotations

import numpy as np

from bez_isaacgym_tpu_torch.control.transformation import Transformation


def wrap_to_pi(x: float) -> float:
    return (x + np.pi) % (2.0 * np.pi) - np.pi


class Path:
    # path.py:20-29
    bodystep_size = 0.04          # m per body step
    angular_bodystep_size = 0.4   # rad per angular step
    steps_per_second = 2.4
    speed = steps_per_second * bodystep_size           # 0.096 m/s
    angular_speed = steps_per_second * angular_bodystep_size
    turn_duration = 4             # body steps to turn
    step_size = 0.02              # planner time resolution [s]
    pre_footstep_ratio = 0.15
    post_footstep_ratio = 0.25

    def __init__(self, start_transform: Transformation,
                 end_transform: Transformation):
        self.start_transform = start_transform
        self.end_transform = end_transform
        # Per-instance copies (the reference mutates class attrs per path).
        self.bodystep_size = float(Path.bodystep_size)
        self.angular_bodystep_size = float(Path.angular_bodystep_size)

        # Arc-length distance map (path.py:36-53).
        precision = 0.05 * self.bodystep_size
        ratios = np.linspace(precision, 1.0, int(1.0 / precision) + 1)
        self.distance = 0.0
        self.angle_distance = 0.0
        prev = self.pose_at_ratio(0.0)
        self.distance_map = np.zeros((len(ratios) + 1, 2))
        for j, r in enumerate(ratios, start=1):
            pose = self.pose_at_ratio(r)
            self.distance += Transformation.distance(prev, pose)
            self.angle_distance += abs(wrap_to_pi(
                pose.get_orientation_euler()[0]
                - prev.get_orientation_euler()[0]))
            prev = pose
            self.distance_map[j] = [r, self.distance]

        # Round the step size so steps divide the distance (path.py:55-69).
        s = self.linear_step_count()
        if self.distance != 0:
            if s == 0:
                # Paths shorter than half a body step: one step of the
                # whole distance (the reference divides by zero here,
                # path.py:55-69 — it never plans sub-2 cm walks).
                self.bodystep_size = self.distance
            elif self.distance % self.bodystep_size < self.bodystep_size / 2:
                self.bodystep_size = self.distance / s
            else:
                self.bodystep_size = self.distance / (s + 1)
        s = self.angular_step_count()
        if self.angle_distance != 0 and s != 0:
            if self.angle_distance % self.angular_bodystep_size < \
                    self.angular_bodystep_size / 2:
                self.angular_bodystep_size = self.angle_distance / s
            else:
                self.angular_bodystep_size = self.angle_distance / (s + 1)

    # -- step counts / durations -------------------------------------------
    def linear_step_count(self) -> int:
        return int(np.floor(self.distance / self.bodystep_size))

    def angular_step_count(self) -> int:
        return int(np.floor(self.angle_distance / self.angular_bodystep_size))

    def body_step_count(self) -> int:
        if self.is_rotate_in_place():
            return self.linear_step_count() + self.angular_step_count()
        return self.linear_step_count()

    def duration(self) -> float:
        if self.is_rotate_in_place():
            return (self.distance / self.speed
                    + self.angle_distance / self.angular_speed)
        return self.distance / self.speed

    def body_step_time(self) -> float:
        return self.duration() / self.body_step_count()

    def is_finished(self, t: float) -> bool:
        return t >= self.duration()

    # -- mode selection -----------------------------------------------------
    def is_rotate_in_place(self) -> bool:
        # path.py:140-143: short paths turn in place instead of arcing.
        d = np.linalg.norm(self.end_transform.get_position()[0:2]
                           - self.start_transform.get_position()[0:2])
        return d < Path.bodystep_size * self.turn_duration * 3

    def is_walking_backwards(self) -> bool:
        start_angle = self.start_transform.get_orientation_euler()[0]
        if self.is_rotate_in_place():
            diff = (self.end_transform.get_position()[0:2]
                    - self.start_transform.get_position()[0:2])
            intermediate = np.arctan2(diff[1], diff[0])
            return abs(wrap_to_pi(intermediate - start_angle)) > np.pi / 2
        delta = (self.end_transform.get_position()
                 - self.start_transform.get_position())
        return float(np.dot([np.cos(start_angle), np.sin(start_angle)],
                            delta[0:2])) < 0

    # -- pose sampling ------------------------------------------------------
    def get_body_step(self, n: float) -> Transformation:
        if self.is_rotate_in_place():
            diff = (self.end_transform.get_position()[0:2]
                    - self.start_transform.get_position()[0:2])
            start_angle = self.start_transform.get_orientation_euler()[0]
            intermediate = np.arctan2(diff[1], diff[0])
            if self.is_walking_backwards():
                intermediate = wrap_to_pi(intermediate + np.pi)
            final_angle = self.end_transform.get_orientation_euler()[0]
            s1 = abs(wrap_to_pi(intermediate - start_angle)) / self.angular_bodystep_size
            s2 = np.linalg.norm(diff) / self.bodystep_size
            s3 = abs(wrap_to_pi(intermediate - final_angle)) / self.angular_bodystep_size
            total = s1 + s2 + s3
            ratio = 0.0 if total == 0 else n / total
            return self.pose_at_ratio(ratio)
        idx = int(np.argmin(np.abs(n * self.bodystep_size
                                   - self.distance_map[:, 1])))
        return self.pose_at_ratio(self.distance_map[idx, 0])

    def pose_at_ratio(self, r: float) -> Transformation:
        if self.is_rotate_in_place():
            return self._pose_rotate_in_place(r)
        pose = self._bezier_position(r)
        ahead = self._bezier_position(r + 0.001)
        if self.is_walking_backwards():
            delta = pose.get_position() - ahead.get_position()
        else:
            delta = ahead.get_position() - pose.get_position()
        yaw = np.arctan2(delta[1], delta[0])
        pitch = np.arctan2(delta[2], np.linalg.norm(delta[0:2]))
        pose.set_orientation(
            Transformation.from_euler([yaw, -pitch, 0.0]).get_orientation())
        return pose

    def _pose_rotate_in_place(self, r: float) -> Transformation:
        """3-phase turn/straight/turn (path.py:170-206)."""
        diff = (self.end_transform.get_position()[0:2]
                - self.start_transform.get_position()[0:2])
        start_angle = self.start_transform.get_orientation_euler()[0]
        intermediate = np.arctan2(diff[1], diff[0])
        if self.is_walking_backwards():
            intermediate = wrap_to_pi(intermediate + np.pi)
        final_angle = self.end_transform.get_orientation_euler()[0]

        d1 = abs(wrap_to_pi(intermediate - start_angle)) / self.angular_speed
        d2 = np.linalg.norm(diff) / self.speed
        d3 = abs(wrap_to_pi(intermediate - final_angle)) / self.angular_speed
        t = r * (d1 + d2 + d3)

        if t == 0:
            return self.start_transform.copy()
        if t < d1 and d1 != 0:
            pose = self.start_transform.copy()
            angle = start_angle + wrap_to_pi(intermediate - start_angle) * (t / d1)
            pose.set_orientation(
                Transformation.from_euler([angle, 0, 0]).get_orientation())
            return pose
        if d1 <= t <= d1 + d2 and d2 != 0:
            pose = self.start_transform.copy()
            pct = (t - d1) / d2
            pos = diff * pct + self.start_transform.get_position()[0:2]
            pose.set_position(np.concatenate([pos, [pose.get_position()[2]]]))
            pose.set_orientation(
                Transformation.from_euler([intermediate, 0, 0]).get_orientation())
            return pose
        if d1 + d2 < t <= d1 + d2 + d3 and d3 != 0:
            pose = self.end_transform.copy()
            pct = (t - d1 - d2) / d3
            angle = intermediate + wrap_to_pi(final_angle - intermediate) * pct
            pose.set_orientation(
                Transformation.from_euler([angle, 0, 0]).get_orientation())
            return pose
        return self.end_transform.copy()

    def _bezier_position(self, r: float) -> Transformation:
        """Cubic Bezier with tangent control points (path.py:208-233)."""
        turn = self.speed * self.turn_duration
        sign = -1.0 if self.is_walking_backwards() else 1.0
        p1 = self.start_transform.H
        p2 = p1 @ Transformation([sign * turn, 0.0, 0.0]).H
        p3 = self.end_transform.H @ Transformation([-sign * turn, 0.0, 0.0]).H
        p4 = self.end_transform.H
        pts = np.stack([p1[0:3, 3], p2[0:3, 3], p3[0:3, 3], p4[0:3, 3]])
        coeff = np.array([(1 - r) ** 3, 3 * (1 - r) ** 2 * r,
                          3 * (1 - r) * r ** 2, r ** 3])
        return Transformation(position=coeff @ pts)
