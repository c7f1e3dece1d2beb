"""The port's classical control stack against the JAX package's.

The planner, IK, transforms, PIDs and walk warm starts are numpy copies:
they must give the JAX package's bits exactly.  The inverse-dynamics
feedforward is rewritten in torch on the port's dynamics and is held to a
stated tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from bez_isaacgym_tpu.control import controller as jctrl  # noqa: E402
from bez_isaacgym_tpu.control import ik as jik  # noqa: E402
from bez_isaacgym_tpu.control import soccerbot as jsb  # noqa: E402
from bez_isaacgym_tpu.control import warmstart as jwarm  # noqa: E402
from bez_isaacgym_tpu.control.transformation import \
    Transformation as JTransformation  # noqa: E402
from bez_isaacgym_tpu.tasks.base import TaskConfig as JTaskConfig  # noqa: E402
from bez_isaacgym_tpu.tasks.walk import WalkTask as JWalkTask  # noqa: E402
from bez_isaacgym_tpu_torch.control import controller as tctrl  # noqa: E402
from bez_isaacgym_tpu_torch.control import ik as tik  # noqa: E402
from bez_isaacgym_tpu_torch.control import soccerbot as tsb  # noqa: E402
from bez_isaacgym_tpu_torch.control import warmstart as twarm  # noqa: E402
from bez_isaacgym_tpu_torch.control.transformation import \
    Transformation  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.base import TaskConfig  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.walk import WalkTask  # noqa: E402

GOALS = {"forward": (0.3, 0.0, 0.0), "backward": (-0.2, 0.1, 0.0),
         "rotate_in_place": (0.0, 0.0, 1.0), "zero_length": (0.0, 0.0, 0.0)}


@pytest.fixture(scope="module")
def tasks():
    return (JWalkTask(JTaskConfig(substeps=4, use_pallas=False)),
            WalkTask(TaskConfig(substeps=4), device="cpu"))


@pytest.mark.parametrize("goal", sorted(GOALS))
def test_plan_joint_trajectory_equals_jax(goal):
    x, y, th = GOALS[goal]
    jt, ja = jctrl.SoccerbotController().plan_joint_trajectory(
        JTransformation.from_xy_theta(x, y, th))
    tt, ta = tctrl.SoccerbotController().plan_joint_trajectory(
        Transformation.from_xy_theta(x, y, th))
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(ta, ja)
    assert (len(tt) == 1) == (goal == "zero_length")


def _poses():
    rng = np.random.default_rng(0)
    for _ in range(5):
        yield (rng.uniform(-0.04, 0.04, 3) + [0.0, -0.035, -0.16],
               rng.uniform(-0.2, 0.2, 3))


@pytest.mark.parametrize("side", ["right", "left"])
def test_ik_equals_jax(side):
    for pos, euler in _poses():
        j = getattr(jik, f"ik_{side}_foot")(
            JTransformation.from_euler(euler, position=pos))
        t = getattr(tik, f"ik_{side}_foot")(
            Transformation.from_euler(euler, position=pos))
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def test_transformation_equals_jax():
    for pos, euler in _poses():
        j = JTransformation.from_euler(euler, position=pos)
        t = Transformation.from_euler(euler, position=pos)
        j2 = JTransformation.from_xy_theta(0.3, -0.2, 0.7)
        t2 = Transformation.from_xy_theta(0.3, -0.2, 0.7)
        for a, b in ((t, j), (t @ t2, j @ j2), (t.inv(), j.inv()),
                     (Transformation.weighted_average(t, t2, 0.3),
                      JTransformation.weighted_average(j, j2, 0.3))):
            np.testing.assert_array_equal(a.H, b.H)
        np.testing.assert_array_equal(t.get_orientation_euler(),
                                      j.get_orientation_euler())
        assert Transformation.distance(t, t2) == \
            JTransformation.distance(j, j2)
        np.testing.assert_array_equal(
            Transformation.from_dh(0.089, 0.3, 0.01, 0.2).H,
            JTransformation.from_dh(0.089, 0.3, 0.01, 0.2).H)


def test_walk_warm_start_equals_jax(tasks):
    goals = np.array([[0.15, 0.0, 0.0], [0.0, 0.0, 0.5], [0.0, 0.0, 0.0]])
    for t0 in (0.0, 1.3):
        ref = jwarm.walk_warm_start(tasks[0], goals, 8, t0=t0)
        got = twarm.walk_warm_start(tasks[1], goals, 8, t0=t0)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_soccerbot_imu_feedback_sequence_equals_jax():
    jbot, tbot = jsb.Soccerbot(), tsb.Soccerbot()
    for b in (jbot, tbot):
        b.ready()
        b.set_goal(type(b.pose).from_xy_theta(0.3, 0.0, 0.0))
    pitches = np.random.default_rng(1).uniform(-0.2, 0.2, 40)
    for i, p in enumerate(pitches):
        jbot.step_path(0.02 * i)
        tbot.step_path(0.02 * i)
        assert tbot.apply_imu_feedback(float(p)) == \
            jbot.apply_imu_feedback(float(p))
        assert tbot.apply_imu_feedback_standing(float(p)) == \
            jbot.apply_imu_feedback_standing(float(p))
        np.testing.assert_array_equal(tbot.get_angles(), jbot.get_angles())


def test_id_feedforward_targets_match_jax(tasks):
    """The computed-torque targets along a short walk plan (and without
    the bias term): torques in f32 on both sides, from the same f64 plan."""
    times, angles = jctrl.SoccerbotController().plan_joint_trajectory(
        JTransformation.from_xy_theta(0.2, 0.0, 0.0))
    times, angles = times[:40], angles[:40]
    for bias in (True, False):
        ref = jctrl.id_feedforward_targets(tasks[0], times, angles, bias)
        got = tctrl.id_feedforward_targets(tasks[1], times, angles, bias)
        assert got.dtype == ref.dtype == np.float64
        # tau_req / kp from f32 torques of the same formula (|tau| <= ~2
        # N m, kp = 100): summation order moves ~1e-7 N m, 1e-9 rad.
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    tau = tctrl.make_tau_fn(tasks[1])(
        *(torch.as_tensor(a[:3], dtype=torch.float32)
          for a in (angles, np.zeros_like(angles), np.zeros_like(angles))))
    assert tau.shape == (3, 18) and torch.isfinite(tau).all()
    np.testing.assert_array_equal(
        tctrl.feedforward_targets(times, angles),
        jctrl.feedforward_targets(times, angles))


class _RecordingEnv:
    """What `SoccerbotController.run` reads and calls: the task's default
    pose, env 0's base quaternion (a fixed 0.1 rad pitch) and `step`."""

    def __init__(self, task, quat, num_envs=2):
        self.task, self.num_envs = task, num_envs
        self.state = type("S", (), {"physics": type("P", (), {
            "base_quat": quat})})()
        self.actions = []

    def step(self, actions):
        self.actions.append(np.array(actions, dtype=np.float64))


def test_controller_run_steps_the_env_as_jax_does(tasks):
    """`run` on the walking plan: the same env.step calls, with the same
    IMU-corrected actions, as the JAX controller's against the same env."""
    quat = np.tile([0.0, np.sin(0.05), 0.0, np.cos(0.05)], (2, 1))
    envs = (_RecordingEnv(tasks[0], quat),
            _RecordingEnv(tasks[1], torch.as_tensor(quat)))
    for ctrl_mod, tf, env in ((jctrl, JTransformation, envs[0]),
                              (tctrl, Transformation, envs[1])):
        ctrl = ctrl_mod.SoccerbotController(env)
        ctrl.ready()
        ctrl.set_goal(tf.from_xy_theta(0.05, 0.0, 0.0))
        ctrl.run()
    assert len(envs[1].actions) == len(envs[0].actions) > 10
    np.testing.assert_array_equal(np.stack(envs[1].actions),
                                  np.stack(envs[0].actions))
    assert envs[1].actions[0].shape == (2, 18)
