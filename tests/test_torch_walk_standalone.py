"""The standalone classical walk (eval/walk_standalone.py) of the port
against the JAX package's, on the CPU.

The approach geometry (`_aim_point`, `_plan_leg`) is numpy f64 in both and
must agree to 1e-9; the feedforward (`_ff_plan`, inverse dynamics in f32)
to 1e-4 relative; and a truncated closed loop of both evals, from the same
JAX reset states carried across with `convert`, returns the same result
dict (rates exactly, distances to 1e-4 m).  The four unit tests of
`tests/test_walk_standalone.py` run on the port's functions.
"""

import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from bez_isaacgym_tpu.control.controller import make_tau_fn as jmake_tau_fn  # noqa: E402
from bez_isaacgym_tpu.eval import walk_standalone as jws  # noqa: E402
from bez_isaacgym_tpu.tasks.walk import WalkTask as JWalkTask  # noqa: E402
from bez_isaacgym_tpu.tasks.walk import walk_config as jwalk_config  # noqa: E402
from bez_isaacgym_tpu_torch.control.controller import make_tau_fn  # noqa: E402
from bez_isaacgym_tpu_torch.eval import walk_standalone as ws  # noqa: E402
from bez_isaacgym_tpu_torch.eval.walk_standalone import (_aim_point,  # noqa: E402
                                                          _plan_leg)
from bez_isaacgym_tpu_torch.tasks.walk import WalkTask  # noqa: E402

import torch_walk_same_states as same  # noqa: E402


def _bearing_diff(goal, pos):
    """The task's UNWRAPPED stray angle (tasks/walk.py)."""
    init = np.arctan2(goal[1], goal[0])
    cur = np.arctan2(goal[1] - pos[1], goal[0] - pos[0])
    return abs(init - cur)


# ---- the four unit tests of tests/test_walk_standalone.py, on the port --

def test_aim_point_on_init_ray_front():
    goal = np.array([0.4, 0.1])
    aim = _aim_point(goal, 0.05, 0.02)
    ray = goal / np.linalg.norm(goal)
    assert np.allclose(aim, goal - 0.05 * ray, atol=1e-9)
    assert _bearing_diff(goal, aim) < 1e-6


def test_aim_point_safe_side_rear():
    """Rear goals get a perpendicular bias AWAY from the atan2 wrap."""
    for goal in (np.array([-0.2, 0.12]), np.array([-0.2, -0.12])):
        bearing = np.arctan2(goal[1], goal[0])
        assert abs(bearing) > 1.8
        aim = _aim_point(goal, 0.03, 0.02)
        cur = np.arctan2(goal[1] - aim[1], goal[0] - aim[0])
        assert abs(cur) < abs(bearing) + 1e-9
        assert _bearing_diff(goal, aim) < 1.0


def test_plan_leg_minimum_turn_heading():
    """A behind-the-robot goal is BACKED into (no in-place pi-turn)."""
    goal = np.array([-0.15, 0.08])
    plan = _plan_leg(np.zeros(2), 0.0, goal, 0.03, 0.02)
    assert np.isfinite(plan).all()
    assert np.abs(np.diff(plan, axis=0)).max() < 0.6
    assert len(plan) < 60 * 4.0


def test_plan_leg_zero_distance_holds_ready():
    plan = _plan_leg(np.array([0.0, 0.0]), 0.0, np.array([0.012, 0.0]),
                     0.02, 0.02)
    assert plan.shape[0] == 1


# ---- the plan functions equal the JAX package's -------------------------

# (xy, yaw, goal, stop_short, safe_offset): front, side, rear with
# |bearing| > 1.8 and > 2.9 (both signs), a robot already turned and moved,
# a backing leg, and a leg below the 2.1 cm hold threshold.
LEGS = {
    "front": ((0.0, 0.0), 0.0, (0.4, 0.1), 0.15, 0.025),
    "side": ((0.0, 0.0), 0.0, (0.05, -0.3), 0.065, 0.025),
    "rear_left": ((0.0, 0.0), 0.0, (-0.2, 0.12), 0.035, 0.025),
    "rear_right_near_pi": ((0.0, 0.0), 0.0, (-0.3, -0.03), 0.065, 0.025),
    "rear_near_pi_moved": ((-0.05, 0.02), 2.8, (-0.35, 0.02), 0.035, 0.025),
    "backing": ((0.02, 0.01), 0.3, (-0.15, 0.08), 0.035, 0.025),
    "hold": ((0.0, 0.0), 0.0, (0.047, 0.0), 0.035, 0.025),
}


@pytest.mark.parametrize("name", sorted(LEGS))
def test_aim_point_equals_jax(name):
    _, _, goal, stop, off = LEGS[name]
    goal = np.array(goal)
    want = jws._aim_point(goal, stop, off)
    got = _aim_point(goal, stop, off)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def _leg_args(name):
    xy, yaw, goal, stop, off = LEGS[name]
    return np.array(xy), yaw, np.array(goal), stop, off


# Each plan takes about a second: made once, shared by the tests below.
@functools.cache
def _jax_plan(name):
    return jws._plan_leg(*_leg_args(name))


@functools.cache
def _port_plan(name):
    return _plan_leg(*_leg_args(name))


@pytest.mark.parametrize("name", sorted(LEGS))
def test_plan_leg_equals_jax(name):
    want = _jax_plan(name)
    got = _port_plan(name)
    assert got.shape == want.shape
    assert (len(got) == 1) == (name == "hold")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_ff_plan_equals_jax():
    """The partial computed-torque feedforward on a real leg plan: port f32
    (one batch) against JAX f32 (chunks of 128 rows), 1e-4 relative."""
    plan = _jax_plan("side")
    assert len(plan) > jws._FF_CHUNK   # more than one JAX chunk
    jtask = JWalkTask(dataclasses.replace(jwalk_config(), use_pallas=False))
    ttask = WalkTask(device="cpu")
    want = jws._ff_plan(jtask, jax.jit(jax.vmap(jmake_tau_fn(jtask))), plan,
                        0.3)
    got = ws._ff_plan(ttask, make_tau_fn(ttask), plan, 0.3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    # Single-row hold plans and alpha 0 carry no feedforward.
    hold = plan[:1]
    assert ws._ff_plan(ttask, None, hold, 0.3) is hold
    assert ws._ff_plan(ttask, None, plan, 0.0) is plan


# ---- a truncated closed loop from the same states -----------------------

LOOP = dict(num_envs=4, seed=3, goal_range=0.5, goal_range_min=0.15,
            episode_length_s=0.6, settle_steps=6)


def _port_eval(states, **kw):
    """The port's eval on the CPU, its first reset taking `states` (the
    task's own auto-resets draw as usual); returns (result, the arguments
    of the leg plans it made)."""
    reset = WalkTask.reset
    calls, plans = [], []
    real_plan = ws._plan_leg

    def first_from_jax(self, gen, n, dr_step=0):
        calls.append(n)
        if len(calls) == 1:
            return states
        return reset(self, gen, n, dr_step)

    def counted_plan(*a):
        plans.append(a)
        return real_plan(*a)

    with mock.patch.object(WalkTask, "reset", first_from_jax), \
            mock.patch.object(ws, "_plan_leg", counted_plan):
        res = ws.eval_classical_walk(device="cpu", **kw)
    assert calls[0] == kw["num_envs"]
    return res, plans


def _assert_same_result(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, float) and k.endswith("_m"):
            assert abs(got[k] - v) <= 1e-4, (k, got[k], v)
        else:
            assert got[k] == v, (k, got[k], v)


def test_truncated_closed_loop_equals_jax():
    """Both evals at 4 envs for 0.6 s, from the JAX eval's own reset
    states: every env settles, plans its first leg from its state (with
    the feedforward) and walks it, and the tallies agree.

    No env wins, falls or strays inside so short a window: every one times
    out, so the equal rates say little.  What tells the packages apart is
    the state: the pose each env plans its leg from, and the goal distances
    after walking it, each to 1e-4 (m, rad)."""
    cfg = {k: LOOP[k] for k in ("goal_range", "goal_range_min",
                                "episode_length_s")}
    states = same.jax_reset_states(LOOP["seed"], LOOP["num_envs"], **cfg)
    jax_plans = []
    real_jax_plan = jws._plan_leg

    def jax_counted_plan(*a):
        jax_plans.append(a)
        return real_jax_plan(*a)

    with mock.patch.object(jws, "_plan_leg", jax_counted_plan):
        want = jws.eval_classical_walk(**LOOP)
    got, plans = _port_eval(states, **LOOP)
    assert len(plans) == len(jax_plans) == LOOP["num_envs"]   # one leg each
    for (xy, yaw, goal, stop, off), (jxy, jyaw, jgoal, jstop, joff) in zip(
            plans, jax_plans):
        np.testing.assert_allclose(xy, jxy, rtol=0, atol=1e-4)
        assert abs(yaw - jyaw) <= 1e-4, (yaw, jyaw)
        np.testing.assert_array_equal(goal, jgoal)
        assert (stop, off) == (jstop, joff)
    assert want["timeout_rate"] + want["fall_rate"] + want["stray_rate"] \
        + want["win_rate"] >= 1.0 - 1e-9, want
    _assert_same_result(got, want)


def test_plans_in_worker_processes_equal_plans_in_process():
    """The legs of one step planned side by side in two spawned workers
    (the eval's `plan_workers`) come back in order, bit for bit the plans
    made one at a time in this process."""
    names = ("side", "hold", "rear_left")
    with ws._plan_pool(1) as pool:
        assert pool is None          # 0 or 1 worker: no pool
    with ws._plan_pool(2) as pool:
        got = ws._plan_legs([_leg_args(n) for n in names], pool)
    for name, plan in zip(names, got):
        np.testing.assert_array_equal(plan, _port_plan(name))


@pytest.mark.slow
def test_classical_walk_wins():
    """Closed loop over full 10 s episodes: the port's engine, from the
    JAX reset states of tests/test_walk_standalone.py's call (seed 1,
    goals 0.2-0.45 m), wins as the JAX test requires."""
    kw = dict(num_envs=4, seed=1, goal_range=0.45, goal_range_min=0.2)
    states = same.jax_reset_states(kw["seed"], kw["num_envs"],
                                   kw["goal_range"], kw["goal_range_min"])
    res, _ = _port_eval(states, **kw)
    assert res["win_rate"] >= 0.5, res
    assert res["stray_rate"] <= 0.25, res


def test_jax_states_match_the_jax_eval():
    """The helper draws the JAX eval's own states: same goals as the JAX
    eval's reset at the same seed and configuration."""
    states = same.jax_reset_states(0, 4, 0.5, 0.15, 10.0)
    task = JWalkTask(dataclasses.replace(
        jwalk_config(), goal_range=0.5, goal_range_min=0.15))
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    ref = jax.jit(jax.vmap(task.reset_one))(keys)
    np.testing.assert_array_equal(states.goal.numpy(), np.asarray(ref.goal))
    np.testing.assert_array_equal(states.physics.q.numpy(),
                                  np.asarray(ref.physics.q))
