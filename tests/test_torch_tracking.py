"""The port's tracking eval against the JAX package's on the CPU.

The oracle and the error metrics are numpy, equal bit for bit.  The drive
runs one env through `step_batch` where the JAX eval ran `step_one`: its
first few steps at substeps 1-2 are held to the JAX drive's on the same
plans (the kick skill with its computed-torque feedforward, and the walk
plan).
"""

import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from bez_isaacgym_tpu.control.trajectories import \
    Trajectory as JTrajectory  # noqa: E402
from bez_isaacgym_tpu.eval import tracking as jtr  # noqa: E402
from bez_isaacgym_tpu.tasks.base import TaskConfig as JTaskConfig  # noqa: E402
from bez_isaacgym_tpu.tasks.kick import KickTask as JKickTask  # noqa: E402
from bez_isaacgym_tpu.tasks.walk import WalkTask as JWalkTask  # noqa: E402
from bez_isaacgym_tpu_torch.eval import tracking as ttr  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.base import TaskConfig  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.kick import KickTask  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.walk import WalkTask  # noqa: E402

STEPS = 6


def test_constants_equal_jax():
    assert ttr.STRIDE_GAIN == jtr.STRIDE_GAIN
    assert ttr.MAX_JOINT_VEL == jtr.MAX_JOINT_VEL


def test_oracle_and_metrics_equal_jax():
    rng = np.random.default_rng(0)
    plan = np.cumsum(rng.uniform(-0.3, 0.3, (50, 18)), axis=0)
    plan[:, :3] = 0.01 * rng.standard_normal((50, 3))   # joints at rest
    np.testing.assert_array_equal(ttr.rate_limited_oracle(plan, 1 / 60),
                                  jtr.rate_limited_oracle(plan, 1 / 60))
    np.testing.assert_array_equal(ttr.rate_limited_oracle(plan, 0.02, 1.0),
                                  jtr.rate_limited_oracle(plan, 0.02, 1.0))
    achieved = plan + 0.05 * rng.standard_normal(plan.shape)
    rel_t, rms_t = ttr._rel_err(achieved, plan)
    rel_j, rms_j = jtr._rel_err(achieved, plan)
    assert rel_t == rel_j
    np.testing.assert_array_equal(rms_t, rms_j)
    assert ttr._nrmse(achieved, plan) == jtr._nrmse(achieved, plan)


def _kick_plan(jtask):
    tr = JTrajectory("simulation_rightkick")
    t60 = np.arange(0.0, tr.max_time, 1 / 60)
    raw = np.stack([tr.angles_at(t) for t in t60])
    return jtr.id_feedforward_targets(jtask, t60, raw)[:STEPS]


@functools.lru_cache(maxsize=1)
def _full_walk_plan():
    """walk_tracking's plan (the planner's numpy copies give equal bits,
    test_torch_control)."""
    return jtr.SoccerbotController().plan_joint_trajectory(
        jtr.Transformation.from_xy_theta(0.5 * jtr.STRIDE_GAIN, 0.0, 0.0))


@functools.lru_cache(maxsize=1)
def _jax_walk_task():
    """One JAX walk task at substeps 2 for every walk test here: tracing
    its step is most of a test's time."""
    task = JWalkTask(JTaskConfig(substeps=2, episode_length_s=60.0,
                                 use_pallas=False))
    task.reset_one = jax.jit(task.reset_one)    # eager ops are slow
    return task


def _walk_plan(jtask):
    return _full_walk_plan()[1][20:20 + STEPS]


@pytest.mark.parametrize("which,substeps", [("kick", 1), ("walk", 2)])
def test_drive_first_steps_match_jax(which, substeps):
    if which == "kick":
        jtask = JKickTask(JTaskConfig(substeps=substeps, use_pallas=False))
        ttask = KickTask(TaskConfig(substeps=substeps), device="cpu")
        plan = _kick_plan(jtask)
    else:
        jtask = _jax_walk_task()
        assert jtask.cfg.substeps == substeps
        ttask = WalkTask(TaskConfig(substeps=substeps, episode_length_s=60.0),
                         device="cpu")
        plan = _walk_plan(jtask)
    ja, jstate = jtr._drive(jtask, plan)
    ta, tstate = ttr._drive(ttask, plan)
    assert ta.shape == ja.shape and ta.dtype == ja.dtype
    # A few control steps of the same f32 engine from the same start:
    # test_torch_kick's bars, positions 1e-5 and velocities 1e-4.
    np.testing.assert_allclose(ta, ja, atol=1e-5)
    for f in ("base_pos", "base_quat", "ball_pos"):
        np.testing.assert_allclose(getattr(tstate.physics, f)[0].numpy(),
                                   np.asarray(getattr(jstate.physics, f)),
                                   atol=1e-5, err_msg=f)
    for f in ("qd", "base_u"):
        np.testing.assert_allclose(getattr(tstate.physics, f)[0].numpy(),
                                   np.asarray(getattr(jstate.physics, f)),
                                   atol=1e-4, err_msg=f)
    assert int(tstate.progress[0]) == int(jstate.progress) == STEPS


def test_drive_holds_the_episode_open():
    """A done flag from the task does not reset the tracked robot: the
    drive's start state with a goal it has already reached (the walk's
    win) still advances, from the ready pose, without a reset."""
    task = WalkTask(TaskConfig(substeps=1, episode_length_s=60.0),
                    device="cpu")
    state, gen = ttr._start(task)
    state = state._replace(goal=state.physics.base_pos[:, :2].clone())
    default = task.default_dof_pos.numpy()
    _, done = task.reward_done(state, torch.zeros(1, 18))
    assert done.all()
    for i in range(3):
        state = ttr._step(task, state, default.astype(np.float64), default,
                          gen)
        assert int(state.progress[0]) == i + 1


PLAN_S = 0.2     # seconds of the walk plan the option tests drive




@pytest.mark.parametrize("imu_feedback,stance_gain", [(False, 0.0),
                                                      (True, 0.5)])
def test_walk_tracking_options_match_jax(imu_feedback, stance_gain):
    """walk_tracking's open-loop drive (imu_feedback=False) and its
    stance-leg gain schedule (stance_gain > 0, on the IMU drive) against
    the JAX package's, on the first PLAN_S s of the walk plan at
    substeps 2: the same metrics, each within 1e-6 (a dozen control
    steps of the same f32 engine; measured 1e-7)."""
    from bez_isaacgym_tpu_torch.control.controller import SoccerbotController

    def jax_task(cfg):
        assert cfg.substeps == 4 and cfg.episode_length_s == 60.0
        return _jax_walk_task()

    def port_task(cfg, device):
        return WalkTask(dataclasses.replace(cfg, substeps=2), device=device)

    times, angles = _full_walk_plan()
    short = times[times <= PLAN_S], angles[times <= PLAN_S]

    def plan(self, goal):
        return short

    kw = dict(imu_feedback=imu_feedback, stance_gain=stance_gain)
    with mock.patch.object(jtr, "WalkTask", jax_task), \
            mock.patch.object(jtr.SoccerbotController,
                              "plan_joint_trajectory", plan):
        ref = jtr.walk_tracking(**kw)
    with mock.patch.object(ttr, "WalkTask", port_task), \
            mock.patch.object(SoccerbotController, "plan_joint_trajectory",
                              plan):
        res = ttr.walk_tracking(device="cpu", **kw)
    assert set(res) == set(ref)
    for k, v in ref.items():
        assert res[k] == pytest.approx(v, abs=1e-6), (k, res[k], v)
