"""Standalone model-based walk: can the engine WIN the walk task?

Port of `bez_isaacgym_tpu/eval/walk_standalone.py`.  No RL policy achieves
the reference walk task's win state (runs/Bez_Walk/walk_eval.json: the
52-dim observation carries goal bearing but never distance, so a policy is
blind to the 5 cm win radius, and the unwrapped-bearing "strayed"
termination punishes everything but a precision stop).  The model-based
engine sees the true state.  This eval drives the classical walking engine
(Bezier body path + footstep phase machine + closed-form leg IK + walking
pitch PID, the reference's own control stack) CLOSED-LOOP toward the
task's randomized goals, with state-feedback replanning between walk
segments: walk to a point just short of the goal, stand, measure the
remaining error from the state, and command a small correction walk if the
win radius is not yet met.  After the final segment the robot holds the
ready pose with the standing ankle PID and an ankle-lean servo until the
episode's own win predicate fires.

Win accounting is IDENTICAL to eval/task_eval.py:eval_walk: the task's
4-condition win state (walk_env.py:943-965) recomputed on the post-step
state of the live episode; falls/strays/timeouts end the attempt.

The physics runs through the CUDA substep kernel on the card.  Each step
the host reads what the phase machine and the tally need (base position,
the torso's x and z axes, joint angles, base velocity, done, progress) in
one copy.  The leg plans (numpy, about a second each) are the path's host
cost; the command line plans the legs that several envs need at one step
side by side in worker processes (one per core, up to 8), with the same
numbers as one at a time.

Usage:
    python -m bez_isaacgym_tpu_torch.eval.walk_standalone \\
        --num-envs 64 --goal-range 0.5 --goal-range-min 0.15
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from bez_isaacgym_tpu_torch import resolve_device
from bez_isaacgym_tpu_torch.control.controller import (SoccerbotController,
                                                       make_tau_fn)
from bez_isaacgym_tpu_torch.control.path import wrap_to_pi
from bez_isaacgym_tpu_torch.control.soccerbot import Joints, Soccerbot
from bez_isaacgym_tpu_torch.control.transformation import Transformation
from bez_isaacgym_tpu_torch.eval.tracking import STRIDE_GAIN
from bez_isaacgym_tpu_torch.ops.quat import quat_axis
from bez_isaacgym_tpu_torch.tasks.walk import WalkTask, walk_config

F32 = torch.float32
DT = 1.0 / 60.0


@dataclasses.dataclass
class _HostView:
    """What the host reads of a batched state, in the dtypes (f32) the JAX
    eval's numpy reads have."""

    xy: np.ndarray        # (B, 2) base position
    x_axis: np.ndarray    # (B, 3) torso x-axis in the world
    up: np.ndarray        # (B,) z of the torso z-axis
    q: np.ndarray         # (B, 18)
    base_u: np.ndarray    # (B, 6)
    done: np.ndarray      # (B,) bool
    progress: np.ndarray  # (B,) int


def _read(state) -> _HostView:
    """One device-to-host copy of everything the loop reads of `state`."""
    ph = state.physics
    packed = torch.cat([
        ph.base_pos[:, :2], quat_axis(ph.base_quat, 0),
        quat_axis(ph.base_quat, 2)[:, 2:3], ph.q, ph.base_u,
        state.done.to(F32)[:, None], state.progress.to(F32)[:, None]],
        dim=-1).cpu().numpy()
    nq = ph.q.shape[1]
    return _HostView(
        xy=packed[:, 0:2], x_axis=packed[:, 2:5], up=packed[:, 5],
        q=packed[:, 6:6 + nq], base_u=packed[:, 6 + nq:12 + nq],
        done=packed[:, 12 + nq] > 0.5,
        progress=packed[:, 13 + nq].astype(np.int64))


class _Tracker:
    """Per-env first-episode accounting (same predicate as eval_walk)."""

    def __init__(self, task, num_envs: int):
        self.default_q = task.default_dof_pos.cpu().numpy()
        self.max_len = task.cfg.max_episode_length
        self.finished = np.zeros(num_envs, bool)
        self.won = np.zeros(num_envs, bool)
        self.fell = np.zeros(num_envs, bool)
        self.strayed = np.zeros(num_envs, bool)
        self.timed_out = np.zeros(num_envs, bool)
        self.min_dist = np.full(num_envs, np.inf)
        self.final_dist = np.full(num_envs, np.nan)
        self.win_step = np.full(num_envs, -1, int)
        self.end_step = np.full(num_envs, -1, int)
        # OR over near-goal steps of the 3 non-distance win conditions —
        # diagnoses WHICH condition blocks a near-goal timeout.
        self.near_conds = np.zeros((num_envs, 3), bool)
        self.goal = None

    def update(self, view: _HostView):
        """Fold one post-step state (its host view) into the tallies."""
        xy = view.xy
        dist = np.linalg.norm(self.goal - xy, axis=-1)
        up = view.up
        live = ~self.finished
        np.minimum(self.min_dist, np.where(live, dist, np.inf),
                   out=self.min_dist)
        pos_err = np.linalg.norm(view.q - self.default_q, axis=-1)
        vel_lin = np.linalg.norm(view.base_u[:, 0:3], axis=-1)
        vel_ang = np.linalg.norm(view.base_u[:, 3:6], axis=-1)
        near = live & (dist < 0.05)
        conds = np.stack([pos_err < 0.15, vel_ang < 0.1, vel_lin < 0.1], 1)
        self.near_conds |= near[:, None] & conds
        w = near & conds.all(1)
        first_win = live & w & ~self.won
        self.won[first_win] = True
        self.win_step[first_win] = view.progress[first_win]
        d = view.done & live
        self.final_dist[d] = dist[d]
        self.end_step[d] = view.progress[d]
        # Fall = the task's own termination test (up_proj < 0.7,
        # walk_env.py:938-939) — a height threshold misclassifies a
        # just-tipping robot as "strayed".
        self.fell[d & (up < 0.7)] = True
        t = view.progress >= self.max_len
        self.timed_out[d & t & ~self.fell] = True
        self.strayed[d & ~self.won & ~self.fell & ~t] = True
        self.finished |= view.done


def _pitch_yaw(view: _HostView):
    """Per-env base pitch and yaw from the torso x-axis (the convention the
    walking stabilizer reads, soccerbot.py:362-372)."""
    x_axis = view.x_axis
    pitch = -np.arcsin(np.clip(x_axis[:, 2], -1.0, 1.0))
    yaw = np.arctan2(x_axis[:, 1], x_axis[:, 0])
    return pitch, yaw


def _aim_point(goal: np.ndarray, stop_short: float,
               safe_offset: float) -> np.ndarray:
    """Approach target ON THE INIT RAY (origin -> goal), stop_short before
    the goal, biased toward the stray-safe side for rear bearings.

    The walk task's stray termination compares the origin->goal bearing with
    the robot->goal bearing UNWRAPPED (walk_env.py:983-990 / tasks/walk.py),
    so for |bearing| > pi/2 the margin on the wrap side is only
    pi - |bearing|: a robot sitting centimetres past/beside a rear goal can
    flip atan2 across +-pi and terminate at -100.  Aiming on the init ray
    maximizes the symmetric margin; the perpendicular `safe_offset` (left of
    the ray for bearing > 0, right for < 0 — drift on that side moves the
    robot->goal bearing AWAY from the wrap) converts the wrap cliff into a
    one-sided margin.
    """
    r = float(np.linalg.norm(goal))
    ray = goal / max(r, 1e-9)
    aim = goal - stop_short * ray
    bearing = float(np.arctan2(goal[1], goal[0]))
    if abs(bearing) > 1.8:
        perp = np.array([-ray[1], ray[0]])
        off = safe_offset
        if abs(bearing) > 2.9:
            # Near-pi bearings: the wrap line (y = goal_y on the goal's +x
            # side) passes within r*sin(pi-|b|) <= ~12 cm of the spawn, so
            # the whole approach must hug the safe side hard.
            off += 0.035
        aim = aim + np.sign(bearing) * off * perp
    return aim


def _plan_leg(xy: np.ndarray, yaw: float, goal: np.ndarray,
              stop_short: float, safe_offset: float) -> np.ndarray:
    """One walk leg from the current pose toward the env's goal.

    Aims at `_aim_point` (stop_short before the goal on the init ray) and
    scales the commanded displacement by the once-measured odometry
    STRIDE_GAIN (eval/tracking.py).  Returns a (T, 18) absolute-joint plan
    on the 60 Hz control grid.
    """
    aim = _aim_point(goal, stop_short, safe_offset)
    dvec = aim - xy
    travel = float(np.arctan2(dvec[1], dvec[0]))
    # Minimum-turn end heading: command the heading the plan's own walk
    # direction produces (forward legs end facing travel; backward legs —
    # the planner backs into behind-the-start goals, path.py:103-114 — end
    # facing away), zeroing the plan's final turn-in-place phase.  In-place
    # turns are the gait's least stable move, and the win state is
    # heading-agnostic, so never turn more than required.
    if abs(wrap_to_pi(travel - yaw)) > np.pi / 2:
        bearing = float(wrap_to_pi(travel + np.pi))
    else:
        bearing = travel
    if np.linalg.norm(dvec) * STRIDE_GAIN < 0.021:
        # Shorter than half a body step (path.py:23 bodystep 0.04; the
        # stride-gain-scaled command is what the planner sees): nothing to
        # walk — hold the ready pose for one tick instead.
        bot = Soccerbot()
        bot.ready()
        return bot.get_angles()[None].copy()
    cmd = xy + dvec * STRIDE_GAIN
    ctrl = SoccerbotController()
    ctrl.soccerbot.pose = Transformation.from_xy_theta(
        float(xy[0]), float(xy[1]), float(yaw))
    times, angles = ctrl.plan_joint_trajectory(
        Transformation.from_xy_theta(float(cmd[0]), float(cmd[1]), bearing))
    t60 = np.arange(0.0, times[-1] + 1e-9, DT)
    return np.stack([np.interp(t60, times, angles[:, j])
                     for j in range(18)], axis=1)


def _plan_leg_args(args: tuple) -> np.ndarray:
    return _plan_leg(*args)


def _plan_legs(requests: list, pool) -> list:
    """The leg plans of one step: `_plan_leg(*r)` for each request, side by
    side in the worker pool when there is one and more than one request."""
    if pool is None or len(requests) < 2:
        return [_plan_leg(*r) for r in requests]
    return list(pool.map(_plan_leg_args, requests))


def _ff_plan(task, tau_fn, plan: np.ndarray, alpha: float) -> np.ndarray:
    """Partial computed-torque feedforward for one (T, 18) plan: the
    inverse dynamics of every plan row in one f32 batch on the task's
    device."""
    if alpha == 0.0 or len(plan) < 2:
        return plan   # single-row hold plans carry no feedforward
    params = task.base_params
    kp = params.kp.cpu().numpy()
    kd = params.kd.cpu().numpy()
    h = task.cfg.dt / task.cfg.substeps
    qd = np.gradient(plan, DT, axis=0)
    qdd = np.gradient(qd, DT, axis=0)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=task.device)

    tau = tau_fn(f32(plan), f32(qd), f32(qdd)).cpu().numpy()
    return plan + alpha * (((h * kp + kd) * qd + tau) / kp)


def host_plan_workers() -> int:
    """The worker processes for the leg plans on this host: one per core
    this process may run on, up to 8."""
    return min(8, len(os.sched_getaffinity(0)))


@contextlib.contextmanager
def _plan_pool(workers: int):
    """The worker processes that plan legs side by side (spawned: the
    parent may hold a CUDA context), or None for workers <= 1."""
    if workers <= 1:
        yield None
        return
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        yield pool


def eval_classical_walk(num_envs: int = 64, seed: int = 0,
                        goal_range: float = 0.5,
                        goal_range_min: float = 0.15,
                        ff_alpha: float = 0.3, stop_short: float = 0.035,
                        leg1_stop: float = 0.15, safe_offset: float = 0.025,
                        settle_steps: int = 24, stand_steps: int = 45,
                        max_replans: int = 5,
                        episode_length_s: float = 10.0,
                        debug: bool = False, plan_workers: int = 0,
                        use_kernel: bool = True, device="cuda") -> dict:
    """Drive the classical engine closed-loop; report win/fall/stray rates.

    Each env runs its OWN phase machine (settle -> walk leg -> stand ->
    replan ... -> hold): legs are planned per env at replanning time from
    that env's true state, so a long first leg in one env never starves
    another env's precision stop (the reference's 10 s episode budget is
    tight at the gait's commanded 0.096 m/s, path.py:20-23).

    plan_workers: processes that plan the legs several envs need at one
    step side by side (spawned, so a calling script needs an
    `if __name__ == "__main__":` guard); 0 or 1 plans every leg in this
    process.  use_kernel=False steps the plain engine on the card too.
    """
    dev = resolve_device(device)
    task = WalkTask(dataclasses.replace(
        walk_config(), goal_range=goal_range, goal_range_min=goal_range_min,
        episode_length_s=episode_length_s, use_kernel=use_kernel),
        device=dev)
    tau_fn = make_tau_fn(task)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = task.reset(gen, num_envs)

    track = _Tracker(task, num_envs)
    track.goal = state.goal.cpu().numpy()
    default = task.default_dof_pos.cpu().numpy()
    bots = [Soccerbot() for _ in range(num_envs)]
    budget = task.cfg.max_episode_length

    SETTLE, WALK, STAND, HOLD = range(4)
    phase = np.full(num_envs, SETTLE)
    counter = np.full(num_envs, settle_steps)
    plans: list = [None] * num_envs
    plan_i = np.zeros(num_envs, int)
    legs = np.zeros(num_envs, int)
    leg_dists: list = [[] for _ in range(num_envs)]
    xy_hist = np.zeros((num_envs, 12, 2))   # rolling pose reads (~0.2 s)
    # Ankle-lean servo state (HOLD phase): quasi-static base-position shift
    # without stepping.  Calibrated on this engine: ankle pitch (both legs)
    # shifts the base ~0.335 m/rad forward, mirrored ankle roll ~0.17 m/rad
    # laterally, at zero velocity and pos_err ~1.41*|delta| — so a combined
    # |delta| <= 0.088 rad stays inside the win's 0.15 rad pose budget and
    # covers the last ~2.8 cm the stepping gait cannot do precisely.
    lean_p = np.zeros(num_envs)   # ankle pitch delta
    lean_r = np.zeros(num_envs)   # ankle roll delta (mirrored)
    LEAN_CAP = 0.088
    LEAN_GAIN = 0.05              # integral gain [rad per m per tick]
    lean_reach = 0.070            # HOLD handles dist < this; hops beyond
    retreated = np.zeros(num_envs, bool)

    def env_tick(e):
        """Env e's phase machine for the current step: it reads the step's
        pose reads and writes `targets[e]`.  Where it needs a leg plan it
        yields the plan's arguments and is sent the plan."""
        if phase[e] in (SETTLE, STAND, HOLD):
            if counter[e] <= 0 and phase[e] != HOLD:
                dist = float(np.linalg.norm(track.goal[e] - xy[e]))
                if phase[e] == STAND:
                    leg_dists[e].append(dist)
                if dist > lean_reach and legs[e] <= max_replans:
                    # Graded approach: every leg that ends inside the
                    # lean envelope (`lean_reach`) hands over to the
                    # stepless ankle-lean servo, so no full gait ever
                    # executes near the goal where sway or a long
                    # stride crosses the stray plane (the
                    # perpendicular-through-goal half-plane test,
                    # tasks/walk.py).  The first chunk — the least
                    # accurate (curved or backing) — is capped at
                    # 0.24 m; rear mid-range goals go straight into
                    # the graded legs.
                    b = float(np.arctan2(track.goal[e][1],
                                         track.goal[e][0]))
                    rear = abs(b) > 2.3
                    if rear and legs[e] == 0 and dist < 0.12 \
                            and not retreated[e]:
                        # Spawn adjacent to a REAR goal: backward
                        # micro-hops slip unpredictably.  One short
                        # retreat (a forward walk away from the goal,
                        # along the init ray) converts it into the
                        # mid-range rear problem the graded legs solve.
                        # legs==0 only: a LATE retreat (after walking)
                        # is a guaranteed timeout in the 10 s budget.
                        stop = 0.18
                        retreated[e] = True
                    elif legs[e] == 0 and dist > 0.30:
                        stop = max(leg1_stop, dist - 0.24)
                    elif dist > 0.12:
                        # Mid hop: aim 6.5 cm short.  4.5 cm aims trade
                        # lean-envelope misses for stray-plane
                        # crossings (gait sway is +-3-4 cm), while 5 cm
                        # final hops under-stride so much that envs
                        # oscillate at 7-8 cm without ever entering the
                        # lean envelope.
                        stop = 0.065
                    else:
                        # Close hop (7-12 cm out): aim 3.5 cm short —
                        # short hops under-stride ~2-3 cm, landing ~5-7.
                        stop = stop_short
                    # Averaged pose read: the robot still rocks a little
                    # mid-stand; a single-instant read biases the plan.
                    xy_e = (xy_hist[e].mean(0)
                            if phase[e] == STAND else xy[e])
                    raw = yield (xy_e, float(yaw[e]), track.goal[e],
                                 stop, safe_offset)
                    if len(raw) == 1:
                        # Displacement below the planner's minimum —
                        # hand over to the lean servo instead.
                        phase[e] = HOLD
                        return
                    plans[e] = _ff_plan(task, tau_fn, raw, ff_alpha)
                    plan_i[e] = 0
                    legs[e] += 1
                    bots[e].reset_imus()
                    phase[e] = WALK
                else:
                    phase[e] = HOLD
            if phase[e] != WALK:
                if phase[e] == HOLD:
                    # Ankle-lean servo: integrate the body-frame goal
                    # offset into static ankle deltas — the base creeps
                    # onto the goal at ~mm/s with all win stillness
                    # conditions already true.
                    pose_err = float(np.linalg.norm(q_all[e] - default))
                    if pose_err > 0.142:
                        # Live pose-budget guard: the win's |q-default|
                        # < 0.15 test (walk_env.py:950-952) must stay
                        # satisfiable.
                        lean_p[e] *= 0.96
                        lean_r[e] *= 0.96
                    off = track.goal[e] - xy_hist[e].mean(0)
                    if (pose_err <= 0.142
                            and float(np.linalg.norm(off)) > 0.03):
                        c, s = np.cos(yaw[e]), np.sin(yaw[e])
                        fwd = c * off[0] + s * off[1]
                        lat = -s * off[0] + c * off[1]
                        lean_p[e] = np.clip(
                            lean_p[e] + LEAN_GAIN * fwd,
                            -LEAN_CAP, LEAN_CAP)
                        lean_r[e] = np.clip(
                            lean_r[e] + 2.0 * LEAN_GAIN * lat,
                            -LEAN_CAP, LEAN_CAP)
                        n = float(np.hypot(lean_p[e], lean_r[e]))
                        if n > LEAN_CAP:
                            lean_p[e] *= LEAN_CAP / n
                            lean_r[e] *= LEAN_CAP / n
                    targets[e, Joints.LEFT_LEG_5] += lean_p[e]
                    targets[e, Joints.RIGHT_LEG_5] += lean_p[e]
                    targets[e, Joints.LEFT_LEG_6] += lean_r[e]
                    targets[e, Joints.RIGHT_LEG_6] -= lean_r[e]
                else:
                    # Ready pose + standing ankle PID
                    # (soccerbot.py:459-488).
                    F = bots[e].stand_pid.update(float(pitch[e]))
                    targets[e, Joints.LEFT_LEG_5] += F
                    targets[e, Joints.RIGHT_LEG_5] += F
                counter[e] -= 1
                return
        # WALK: stream this env's leg plan + walking arm PID
        # (soccerbot.py:415-457).
        targets[e] = plans[e][plan_i[e]]
        F = bots[e].apply_imu_feedback(float(pitch[e]))
        targets[e, Joints.LEFT_ARM_1] += 5.0 * F
        targets[e, Joints.RIGHT_ARM_1] += 5.0 * F
        plan_i[e] += 1
        if plan_i[e] >= len(plans[e]):
            phase[e] = STAND
            # The stand after leg 1 only needs a stable position read
            # (~0.75 s); later stands must outlast the post-gait
            # rocking so the win's stillness conditions can fire.
            counter[e] = 40 if legs[e] == 1 else stand_steps
            bots[e].reset_imus()

    with _plan_pool(plan_workers) as pool:
        view = _read(state)
        t_wall = time.time()
        for t_global in range(budget + settle_steps):
            if track.finished.all():
                break
            if debug and t_global % 100 == 0:
                print(f"[t={t_global} live={int((~track.finished).sum())} "
                      f"legs={int(legs.sum())} "
                      f"wall={time.time() - t_wall:.0f}s]",
                      file=sys.stderr, flush=True)
            pitch, yaw = _pitch_yaw(view)
            xy = view.xy
            q_all = view.q
            xy_hist = np.roll(xy_hist, 1, axis=1)
            xy_hist[:, 0] = xy
            targets = np.broadcast_to(default, (num_envs, 18)).copy()

            # Every live env runs up to its leg plan; the plans of this step
            # are made together, then each env resumes with its own.
            waiting = []
            for e in range(num_envs):
                if track.finished[e]:
                    continue
                tick = env_tick(e)
                request = next(tick, None)
                if request is not None:
                    waiting.append((tick, request))
            raws = _plan_legs([r for _, r in waiting], pool)
            for (tick, _), raw in zip(waiting, raws):
                with contextlib.suppress(StopIteration):
                    tick.send(raw)
            out = task.step_batch(
                state, torch.as_tensor(targets - default, device=task.device),
                gen)
            state = out.state
            view = _read(state)
            track.update(view)

    replans = int(np.maximum(legs - 1, 0).sum())
    ok = np.isfinite(track.min_dist)
    win_steps = track.win_step[track.win_step >= 0]
    if debug:
        goal_r = np.linalg.norm(track.goal, axis=-1)
        bearing = np.arctan2(track.goal[:, 1], track.goal[:, 0])
        print("env  goal_r bearing  outcome end@ conds(pose/angv/linv)"
              " legs | dist after each leg (cm)")
        for e in range(num_envs):
            tag = ("WIN" if track.won[e] else "fell" if track.fell[e]
                   else "stray" if track.strayed[e]
                   else "t.o." if track.timed_out[e] else "live")
            ds = " ".join(f"{d*100:5.1f}" for d in leg_dists[e])
            nc = "".join("y" if c else "n" for c in track.near_conds[e])
            print(f"{e:3d}  {goal_r[e]:.2f}  {bearing[e]:+.2f}  {tag:5s}"
                  f" {track.end_step[e]:4d} {nc} {legs[e]:2d} | {ds}")
    return {
        "num_envs": num_envs,
        "goal_range": goal_range,
        "goal_range_min": goal_range_min,
        "episode_length_s": episode_length_s,
        "policy_prior": None,
        "win_rate": float(track.won.mean()),
        "fall_rate": float(track.fell.mean()),
        "stray_rate": float(track.strayed.mean()),
        "timeout_rate": float(track.timed_out.mean()),
        "reach_rate_0.25m": float((track.min_dist < 0.25).mean()),
        "mean_min_goal_dist_m": float(track.min_dist[ok].mean()),
        "mean_final_goal_dist_m": float(np.nanmean(track.final_dist)),
        "mean_win_step": float(win_steps.mean()) if len(win_steps) else None,
        "replanned_segments": int(replans),
        "config": {"ff_alpha": ff_alpha, "stop_short": stop_short,
                   "leg1_stop": leg1_stop, "safe_offset": safe_offset,
                   "settle_steps": settle_steps, "stand_steps": stand_steps,
                   "max_replans": max_replans,
                   "lean_reach": lean_reach, "lean_cap": LEAN_CAP,
                   "stride_gain": float(STRIDE_GAIN)},
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-envs", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--goal-range", type=float, default=0.5)
    ap.add_argument("--goal-range-min", type=float, default=0.15)
    ap.add_argument("--ff-alpha", type=float, default=0.3)
    ap.add_argument("--stop-short", type=float, default=0.035)
    ap.add_argument("--max-replans", type=int, default=5)
    ap.add_argument("--episode-length-s", type=float, default=10.0)
    ap.add_argument("--plain-engine", action="store_true",
                    help="step the plain PyTorch engine instead of the CUDA "
                         "substep kernel (to tell the kernel from the rest "
                         "of the port)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain engine")
    args = ap.parse_args(argv)
    return eval_classical_walk(
        num_envs=args.num_envs, seed=args.seed, goal_range=args.goal_range,
        goal_range_min=args.goal_range_min, ff_alpha=args.ff_alpha,
        stop_short=args.stop_short, max_replans=args.max_replans,
        episode_length_s=args.episode_length_s,
        plan_workers=host_plan_workers(), use_kernel=not args.plain_engine,
        device=args.device)


if __name__ == "__main__":
    print(json.dumps(main(), indent=1))
