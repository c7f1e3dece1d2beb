"""The serving slice as a whole: checkpoint -> player -> closed loop.

Both sides start from the same states (JAX `reset_one`, carried across
with `convert`); neither resets itself.  The trained kick policy drives the
closed loop and serves as MPPI's prior; the MPPI noise is the JAX solve's
own draw, as in tests/test_torch_mppi.py.  The eval entry points run end
to end on the CPU at a tiny size.  S <= 4, substeps=1.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bez_isaacgym_tpu.control import trajectories as jtraj  # noqa: E402
from bez_isaacgym_tpu.control import warmstart as jwarm  # noqa: E402
from bez_isaacgym_tpu.envs.vec_env import VecEnv as JVecEnv  # noqa: E402
from bez_isaacgym_tpu.rl.players import PpoPlayerContinuous as JPlayer  # noqa: E402
from bez_isaacgym_tpu.solvers.mppi import MPPIConfig as JMPPIConfig  # noqa: E402
from bez_isaacgym_tpu.solvers.mppi import MPPISolver as JMPPISolver  # noqa: E402
from bez_isaacgym_tpu.solvers.mppi import MPPIState as JMPPIState  # noqa: E402
from bez_isaacgym_tpu.tasks.base import TaskConfig as JTaskConfig  # noqa: E402
from bez_isaacgym_tpu.tasks.kick import KickTask as JKickTask  # noqa: E402
from bez_isaacgym_tpu_torch import convert  # noqa: E402
from bez_isaacgym_tpu_torch.control import trajectories as ttraj  # noqa: E402
from bez_isaacgym_tpu_torch.control import warmstart as twarm  # noqa: E402
from bez_isaacgym_tpu_torch.envs.vec_env import VecEnv  # noqa: E402
from bez_isaacgym_tpu_torch.eval import kick_eval  # noqa: E402
from bez_isaacgym_tpu_torch.rl.players import PpoPlayerContinuous  # noqa: E402
from bez_isaacgym_tpu_torch.solvers.mppi import MPPIConfig, MPPISolver  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.base import TaskConfig  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.kick import KickTask  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KICK = str(ROOT / "runs" / "Bez_Kick" / "Bez_Kick_best.ckpt")
S, NA = 4, 18


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def case():
    jtask = JKickTask(JTaskConfig(substeps=1, use_pallas=False))
    ttask = KickTask(TaskConfig(substeps=1), device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(0), S)
    jstate = jax.jit(jax.vmap(jtask.reset_one))(keys)
    return dict(jtask=jtask, ttask=ttask, jstate=jstate,
                tstate=convert.env_state(_np(jstate)),
                jplayer=JPlayer(jtask, checkpoint_path=KICK),
                tplayer=PpoPlayerContinuous(ttask, checkpoint_path=KICK,
                                            device="cpu"))


def test_closed_loop_ticks_match_jax(case):
    """Three ticks of observe -> policy -> step_batch, as eval_policy runs
    them, from the same reset states."""
    jtask, ttask = case["jtask"], case["ttask"]
    jobs, jst = jax.jit(jax.vmap(jtask.observe))(
        case["jstate"], jnp.zeros((S, NA), jnp.float32))
    tobs, tst = ttask.observe(case["tstate"], torch.zeros((S, NA)))
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-4)
    jstep = jax.jit(jtask.step_batch)
    gen = torch.Generator().manual_seed(0)
    for tick in range(3):
        ja = case["jplayer"].get_action(jobs, True)
        ta = case["tplayer"].get_action(tobs, True)
        # The policy on observations equal to 1e-4 (the IMU's 1/dt
        # amplification): actions agree to 1e-4.
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-4,
                                   err_msg=f"tick {tick}")
        jout = _np(jstep(jst, ja))
        tout = ttask.step_batch(tst, ta, gen)
        assert not jout.done.any(), "no env may reset: RNGs differ"
        np.testing.assert_array_equal(tout.done.numpy(), jout.done)
        # test_torch_kick's bars for one control step.
        for f in ("q", "base_pos", "base_quat", "ball_pos"):
            np.testing.assert_allclose(
                getattr(tout.state.physics, f).numpy(),
                getattr(jout.state.physics, f), atol=1e-5, err_msg=f)
        for f in ("qd", "base_u", "ball_vel"):
            np.testing.assert_allclose(
                getattr(tout.state.physics, f).numpy(),
                getattr(jout.state.physics, f), atol=1e-4, err_msg=f)
        np.testing.assert_allclose(tout.reward.numpy(), jout.reward,
                                   atol=1e-5)
        np.testing.assert_allclose(tout.obs.numpy(), jout.obs, atol=1e-4)
        jst, jobs = jstep(jst, ja).state, jnp.asarray(jout.obs)
        tst, tobs = tout.state, tout.obs


def test_mppi_with_the_policy_prior_matches_jax(case):
    """One MPPI solve around the trained policy (K=4, H=2, 2 recovery
    samples); the noise is the JAX solve's own draw."""
    H, K, R = 2, 4, 2
    kw = dict(horizon=H, num_samples=K, sigma=0.03, elite=True,
              zero_nominal_sample=True, recovery_samples=R,
              recovery_gate=2.0, balance_weight=0.6,
              terminal_balance_weight=10.0)
    jp, tp = case["jplayer"], case["tplayer"]
    ts, key0 = jp.train_state, jax.random.PRNGKey(0)
    jsolver = JMPPISolver(case["jtask"], JMPPIConfig(**kw),
                          prior_fn=lambda o: jp._act(ts, o, key0, True))
    key = jax.random.PRNGKey(7)
    nominal = np.random.default_rng(3).uniform(
        -0.05, 0.05, (S, H, NA)).astype(np.float32)
    ja, jm, jinfo = jax.jit(jsolver.solve)(
        case["jstate"], JMPPIState(nominal=jnp.asarray(nominal)), key)
    noise = np.array(jax.random.normal(key, (S, K, H, NA), jnp.float32))
    rec = np.array(jax.random.normal(jax.random.fold_in(key, 1),
                                     (S, R, H, NA), jnp.float32))
    tsolver = MPPISolver(case["ttask"], MPPIConfig(**kw),
                         prior_fn=lambda o: tp.get_action(o, True))
    ta, tm, tinfo = tsolver.solve(
        case["tstate"], convert.mppi_state(JMPPIState(nominal=nominal)),
        noise=torch.as_tensor(noise), recovery_noise=torch.as_tensor(rec))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-4)
    np.testing.assert_allclose(tm.nominal.numpy(), np.asarray(jm.nominal),
                               atol=1e-5)
    np.testing.assert_allclose(tinfo["best_score"].numpy(),
                               np.asarray(jinfo["best_score"]), atol=1e-4)


def test_skill_warm_start_and_angles_equal_jax(case):
    skill = "simulation_rightkick"
    jt, tt = jtraj.Trajectory(skill), ttraj.Trajectory(skill)
    for t in (0.0, 0.004, 0.5, 1.37, tt.max_time, tt.max_time + 1.0):
        np.testing.assert_array_equal(tt.angles_at(t), jt.angles_at(t))
    mj = jtraj.Trajectory(skill, mirror=True)
    mt = ttraj.Trajectory(skill, mirror=True)
    np.testing.assert_array_equal(mt.angles_at(0.9), mj.angles_at(0.9))
    assert ttraj.available_skills() == jtraj.available_skills()
    t0s = (0.0, 5 / 60, 1.0, 2.9, 4.0)
    plans = twarm.skill_warm_starts(case["ttask"], skill, 8, t0s)
    for i, t0 in enumerate(t0s):
        ref = jwarm.skill_warm_start(case["jtask"], skill, 8, t0=t0, num=3)
        got = twarm.skill_warm_start(case["ttask"], skill, 8, t0=t0, num=3)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(plans[i], ref[0])


def test_vec_env_reset_and_step_match_jax(case, monkeypatch):
    """VecEnv from a converted state: reset's zero-action step, then one
    step with the policy's actions."""
    jenv = JVecEnv(case["jtask"], S)
    tenv = VecEnv(case["ttask"], S)
    monkeypatch.setattr(jenv, "_reset_fn", lambda keys: case["jstate"])
    # The task's own resets of done envs in step_batch get the same state;
    # no env is done here, so they are masked out.
    monkeypatch.setattr(case["ttask"], "reset",
                        lambda gen, n, dr_step=0: case["tstate"])
    np.testing.assert_allclose(tenv.reset().numpy(),
                               np.asarray(jenv.reset()), atol=1e-4)
    assert tenv.observation_space.shape == jenv.observation_space.shape
    np.testing.assert_array_equal(tenv.action_space.high,
                                  jenv.action_space.high)
    actions = np.random.default_rng(5).uniform(-0.3, 0.3, (S, NA)).astype(
        np.float32)
    jo, jr, jd, jinfo = _np(jenv.step(actions))
    to, tr, td, tinfo = tenv.step(actions)
    np.testing.assert_allclose(to.numpy(), jo, atol=1e-4)
    np.testing.assert_allclose(tr.numpy(), jr, atol=1e-5)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_array_equal(tinfo["time_outs"].numpy(),
                                  jinfo["time_outs"])


def _jax_result_keys(fn_name: str):
    """Keys of the dict the JAX eval returns (read from its source), with
    the nested config dict's keys."""
    src = (ROOT / "bez_isaacgym_tpu" / "eval" / "kick_eval.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return)][-1].value
    keys = {k.value for k in ret.keys}
    config = [v for k, v in zip(ret.keys, ret.values) if k.value == "config"]
    return keys, ({k.value for k in config[0].keys} if config else None)


def test_eval_policy_runs_and_returns_the_jax_keys():
    res = kick_eval.eval_policy(KICK, num_envs=2, steps=2, device="cpu")
    keys, _ = _jax_result_keys("eval_policy")
    assert set(res) == keys
    assert res["num_envs"] == 2 and res["mean_ep_steps"] == 2.0
    assert all(np.isfinite(v) for v in res.values())


@pytest.mark.parametrize("variant", ["policy_prior", "warm_skill"])
def test_eval_mppi_runs_and_returns_the_jax_keys(variant):
    kw = (dict(policy_prior=KICK, recovery_samples=2) if variant ==
          "policy_prior" else dict(warm_skill="simulation_rightkick"))
    res = kick_eval.eval_mppi(num_envs=2, steps=2, horizon=2, num_samples=4,
                              substeps=1, elite=True,
                              zero_nominal_sample=True, device="cpu", **kw)
    keys, config_keys = _jax_result_keys("eval_mppi")
    assert set(res) == keys and set(res["config"]) == config_keys
    assert all(np.isfinite(res[k]) for k in keys - {"config"})
