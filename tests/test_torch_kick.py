"""The port's KickTask against the JAX KickTask on the CPU.

Both sides start from the same batched states: JAX `reset_one` states,
perturbed with a seeded numpy RNG and carried across with
`bez_isaacgym_tpu_torch.convert`.  Actions come from the same RNG.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bez_isaacgym_tpu.tasks.base import TaskConfig as JTaskConfig  # noqa: E402
from bez_isaacgym_tpu.tasks.kick import KickTask as JKickTask  # noqa: E402
from bez_isaacgym_tpu_torch import convert  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.base import TaskConfig  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.kick import KickTask  # noqa: E402

S = 4
SUBSTEPS = 1


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def case():
    jtask = JKickTask(JTaskConfig(substeps=SUBSTEPS, use_pallas=False))
    ttask = KickTask(TaskConfig(substeps=SUBSTEPS), device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(0), S)
    jstate = jax.jit(jax.vmap(jtask.reset_one))(keys)
    rng = np.random.default_rng(0)
    ph = jstate.physics
    ph = ph._replace(
        qd=ph.qd + rng.uniform(-0.5, 0.5, ph.qd.shape).astype(np.float32),
        base_u=jnp.asarray(rng.uniform(-0.3, 0.3, (S, 6)), jnp.float32),
        ball_vel=jnp.asarray(rng.uniform(-1, 1, (S, 3)), jnp.float32))
    jstate = jstate._replace(
        physics=ph,
        progress=jnp.asarray(rng.integers(0, 5, S), jnp.int32),
        prev_lin_vel=jnp.asarray(rng.uniform(-0.2, 0.2, (S, 3)),
                                 jnp.float32))
    actions = rng.uniform(-0.3, 0.3, (S, 18)).astype(np.float32)
    jout = jax.jit(jtask.step_batch)(jstate, jnp.asarray(actions))
    jobs = jax.jit(jax.vmap(jtask.observe))(jstate, jnp.asarray(actions))
    jrd = jax.jit(jax.vmap(jtask.reward_done))(jstate, jnp.asarray(actions))
    tstate = convert.env_state(_np(jstate))
    return dict(jtask=jtask, ttask=ttask, jstate=jstate, tstate=tstate,
                actions=actions, jout=_np(jout), jobs=_np(jobs),
                jrd=_np(jrd))


def test_observe_matches_jax(case):
    obs, st = case["ttask"].observe(case["tstate"],
                                    torch.as_tensor(case["actions"]))
    jobs, jst = case["jobs"]
    assert obs.shape == (S, 54)
    # f32 elementwise math in both; the IMU divides a velocity difference
    # by dt = 1/60, so 1e-4 absolute covers the amplified rounding.
    np.testing.assert_allclose(obs.numpy(), jobs, atol=1e-4)
    np.testing.assert_allclose(st.prev_lin_vel.numpy(), jst.prev_lin_vel,
                               atol=1e-6)


def test_reward_done_matches_jax(case):
    reward, done = case["ttask"].reward_done(case["tstate"],
                                             torch.as_tensor(case["actions"]))
    jr, jd = case["jrd"]
    np.testing.assert_array_equal(done.numpy(), jd)
    # Same f32 formula; norms and atan2 round differently (1e-5).
    np.testing.assert_allclose(reward.numpy(), jr, atol=1e-5)


@pytest.mark.parametrize("field", ["q", "qd", "base_pos", "base_quat",
                                   "base_u", "ball_pos", "ball_vel"])
def test_step_batch_physics_matches_jax(case, field):
    out = case["ttask"].step_batch(case["tstate"],
                                   torch.as_tensor(case["actions"]),
                                   torch.Generator().manual_seed(0))
    ref = getattr(case["jout"].state.physics, field)
    got = getattr(out.state.physics, field).numpy()
    # One control step of the same f32 engine: measured differences are
    # ~1e-7 (velocities) and ~1e-8 (positions); the bars leave 100x for
    # summation-order changes, velocities carrying the 1/h amplification.
    atol = 1e-4 if field in ("qd", "base_u", "ball_vel") else 1e-5
    np.testing.assert_allclose(got, ref, atol=atol)


def test_step_batch_outputs_match_jax(case):
    out = case["ttask"].step_batch(case["tstate"],
                                   torch.as_tensor(case["actions"]),
                                   torch.Generator().manual_seed(0))
    j = case["jout"]
    np.testing.assert_array_equal(out.done.numpy(), j.done)
    np.testing.assert_array_equal(out.time_out.numpy(), j.time_out)
    np.testing.assert_array_equal(out.state.progress.numpy(),
                                  j.state.progress)
    # Rewards and obs after one engine step (measured <= 2e-6): the IMU
    # term divides a velocity difference by dt = 1/60, hence 1e-4 on obs.
    np.testing.assert_allclose(out.reward.numpy(), j.reward, atol=1e-5)
    np.testing.assert_allclose(out.obs.numpy(), j.obs, atol=1e-4)


def test_done_envs_reset_inside_noise_box(case):
    task = case["ttask"]
    done = torch.tensor([True, False, True, False])
    state = case["tstate"]._replace(done=done)
    out = task.step_batch(state, torch.as_tensor(case["actions"]),
                          torch.Generator().manual_seed(1))
    st = out.state
    cfg = task.cfg
    q0 = task.default_dof_pos
    reset = done.numpy()
    assert (st.progress.numpy()[reset] == 0).all()
    assert (st.progress.numpy()[~reset] > 0).all()
    dq = (st.physics.q[done] - q0).abs()
    assert (dq <= cfg.reset_dof_pos_noise + 1e-6).all()
    assert (st.physics.qd[done].abs() <= cfg.reset_dof_vel_noise + 1e-6).all()
    np.testing.assert_allclose(st.physics.base_pos[done].numpy(),
                               np.tile(cfg.bez_init_pos, (2, 1)), atol=1e-7)
    assert (st.physics.base_u[done] == 0).all()
    # The not-done envs advanced exactly as without resets.
    plain = task.step_batch(case["tstate"], torch.as_tensor(case["actions"]),
                            torch.Generator().manual_seed(1))
    torch.testing.assert_close(st.physics.q[~done],
                               plain.state.physics.q[~done])
