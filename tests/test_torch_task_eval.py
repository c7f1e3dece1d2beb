"""The goalie, orient and walk serving slice: checkpoint -> player -> closed
loop, against the JAX package on the CPU.

Both sides start from the same states (JAX `reset_one`, carried across with
`convert`); each task's shipped checkpoint drives three closed-loop ticks
(player, then step) on both.  Each eval entry point runs end to end on the
CPU at a tiny size against the JAX package's eval from the same states,
and returns the same tallies.  S = 4, substeps = 1.
"""

import dataclasses
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bez_isaacgym_tpu.rl.players import PpoPlayerContinuous as JPlayer  # noqa: E402
from bez_isaacgym_tpu.tasks import registry as jreg  # noqa: E402
from bez_isaacgym_tpu_torch import convert  # noqa: E402
from bez_isaacgym_tpu_torch.eval import task_eval  # noqa: E402
from bez_isaacgym_tpu_torch.rl.players import PpoPlayerContinuous  # noqa: E402
from bez_isaacgym_tpu_torch.tasks import registry as treg  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CKPT = {name: str(ROOT / "runs" / run / f"{run}_best.ckpt")
        for name, run in (("goalie", "Bez_Goalie"), ("orient", "Bez_Orient"),
                          ("walk", "Bez_Walk"))}
S, NA = 4, 18


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("name", sorted(CKPT))
def test_closed_loop_ticks_match_jax(name):
    """Three ticks of observe -> policy -> step_batch, as the evals run
    them, from the same reset states."""
    key = f"bez_{name}"
    jtask = jreg.make_task(key, dataclasses.replace(
        jreg.default_configs[key](), substeps=1, use_pallas=False))
    ttask = treg.make_task(key, dataclasses.replace(
        treg.default_configs[key](), substeps=1), device="cpu")
    jplayer = JPlayer(jtask, checkpoint_path=CKPT[name])
    tplayer = PpoPlayerContinuous(ttask, checkpoint_path=CKPT[name],
                                  device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(0), S)
    jst = jax.jit(jax.vmap(jtask.reset_one))(keys)
    tst = convert.env_state(_np(jst))
    jobs, jst = jax.jit(jax.vmap(jtask.observe))(
        jst, jnp.zeros((S, NA), jnp.float32))
    tobs, tst = ttask.observe(tst, torch.zeros((S, NA)))
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-4)
    jstep = jax.jit(jtask.step_batch)
    gen = torch.Generator().manual_seed(0)
    # Velocities, and the observations and actions made from them: 1e-4
    # (test_torch_kick's bar for one control step).  The goalie starts at
    # z = 0.29 with its box feet in the ground and Kd = 0: the first
    # step's stiff contact forces carry the f32 rounding to 1.8e-4 in qd
    # (5e-5 relative), measured; its bar is 5e-4, and 60x that on the
    # observations, whose IMU term divides a velocity difference by 1/60 s.
    vtol = 5e-4 if name == "goalie" else 1e-4
    otol = 60 * vtol if name == "goalie" else 1e-4
    for tick in range(3):
        ja = jplayer.get_action(jobs, True)
        ta = tplayer.get_action(tobs, True)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=vtol,
                                   err_msg=f"tick {tick}")
        jout_dev = jstep(jst, ja)
        jout = _np(jout_dev)
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
                getattr(jout.state.physics, f), atol=vtol, err_msg=f)
        np.testing.assert_allclose(tout.reward.numpy(), jout.reward,
                                   atol=1e-5)
        np.testing.assert_allclose(tout.obs.numpy(), jout.obs, atol=otol)
        jst, jobs = jout_dev.state, jout_dev.obs
        tst, tobs = tout.state, tout.obs


STEPS = 6


def _fallen(task_cls, cfg):
    """A robot that has fallen on its back: the port's plain engine drops
    it from 0.2 m pitched a quarter turn and lets it settle 60 steps."""
    task = task_cls(cfg, device="cpu")
    st = task.reset(torch.Generator().manual_seed(0), 1)
    c = np.float32(np.sqrt(0.5))
    ph = st.physics._replace(
        q=task.default_dof_pos[None].clone(), qd=torch.zeros(1, NA),
        base_pos=torch.tensor([[0.0, 0.0, 0.2]]),
        base_quat=torch.tensor([[0.0, c, 0.0, c]]))
    for _ in range(60):
        ph = task._step_physics_batch(st.dyn, ph, task.default_dof_pos[None])
    return ph


def _scenarios(name, st, jtask, fallen):
    """Set the S JAX reset states up so every tally of the eval fires
    within STEPS steps.  Env 0 runs as drawn; env 1 has fallen; env 2
    holds still (its actions are zeroed); env 3 ends early."""
    ph, last = st.physics, jtask.cfg.max_episode_length - 3
    for f in ("q", "qd", "base_pos", "base_quat", "base_u"):
        getattr(ph, f)[1] = getattr(fallen, f)[0].numpy()
    if name == "goalie":
        ph.ball_pos[1], ph.ball_vel[1] = (0.6, 0.0, 0.1), 0.0  # stopped
        ph.ball_pos[2], ph.ball_vel[2] = (1.5, 0.0, 0.1), 0.0  # cleared
        ph.ball_pos[3] = (0.15, 0.4, 0.1)          # passes beside: conceded
    elif name == "orient":
        st.progress[2], st.goal_angle[2] = last, 0.1   # horizon, on heading
        ph.base_pos[3, 0] += 0.5                       # drifted
    else:
        ph.q[2], ph.qd[2], ph.base_u[2] = jtask.default_dof_pos, 0.0, 0.0
        st.goal[2] = ph.base_pos[2, :2] + (0.01, 0.0)  # a win
        st.progress[3] = last                          # horizon
    return st


# What the scenarios make each eval report (JAX side), so that the
# comparison below cannot pass on tallies that never fired.
FIRED = {
    "goalie": {"block_rate": 0.5, "conceded_rate": 0.25, "clear_rate": 0.25,
               "fall_rate": 0.25},
    "orient": {"episodes_finished": 3, "within_0.2rad": 1 / 3,
               "upright_rate": 2 / 3},
    "walk": {"episodes_finished": 3, "win_rate": 0.25,
             "reach_rate_0.25m": 0.25, "fall_rate": 0.25},
}


@pytest.mark.parametrize("name", sorted(CKPT))
def test_eval_runs_and_returns_the_jax_keys(name):
    """Each eval on the CPU against the JAX package's on the same states
    and actions: both evals start from the JAX `reset_one` states (set up
    by `_scenarios`), run STEPS steps at S = 4, substeps = 1, and must
    return the same dict: every key, the rates and counts exactly, the
    continuous tallies within 1e-5 relative (a few control steps of the
    same f32 engine; measured 1e-7)."""
    import bez_isaacgym_tpu.rl.players as jplayers
    from bez_isaacgym_tpu.eval import task_eval as jeval

    key = f"bez_{name}"
    jmod = sys.modules[jreg.task_map[key].__module__]
    tmod = sys.modules[treg.task_map[key].__module__]
    cfg_fn = f"{name}_config"
    jcfg = dataclasses.replace(getattr(jmod, cfg_fn)(), substeps=1,
                               use_pallas=False)
    tcfg = dataclasses.replace(getattr(tmod, cfg_fn)(), substeps=1)
    jtask = jreg.task_map[key](jcfg)
    keys = jax.random.split(jax.random.PRNGKey(0), S)
    st = jax.tree.map(np.array, jax.jit(jax.vmap(jtask.reset_one))(keys))
    st = _scenarios(name, st, jtask, _fallen(treg.task_map[key], tcfg))
    table, table_keys = jax.tree.map(jnp.asarray, st), jnp.asarray(keys)

    def jax_reset_one(self, rkey, dr_step=0):
        # The eval's reset keys pick their env's state; the auto-resets
        # after a first episode (which no tally reads) take env 0's.
        i = jnp.argmax(jnp.all(rkey == table_keys, axis=-1))
        return jax.tree.map(lambda a: a[i], table)

    hold = np.ones((S, 1), np.float32)
    hold[2] = 0.0

    class JHeld(jplayers.PpoPlayerContinuous):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            act = self._act
            self._act = lambda *a2: act(*a2) * hold

    with mock.patch.object(jmod, cfg_fn, lambda: jcfg), \
            mock.patch.object(jreg.task_map[key], "reset_one",
                              jax_reset_one), \
            mock.patch.object(jplayers, "PpoPlayerContinuous", JHeld):
        ref = getattr(jeval, f"eval_{name}")(CKPT[name], S, STEPS, 0)

    first = convert.env_state(st)
    real_reset, resets = treg.task_map[key].reset, []

    def port_reset(self, gen, n, dr_step=0):
        resets.append(n)
        return first if len(resets) == 1 else real_reset(self, gen, n,
                                                          dr_step)

    real_get_action = PpoPlayerContinuous.get_action

    def held(self, obs, *a, **k):
        return real_get_action(self, obs, *a, **k) * torch.as_tensor(hold)

    with mock.patch.object(tmod, cfg_fn, lambda: tcfg), \
            mock.patch.object(treg.task_map[key], "reset", port_reset), \
            mock.patch.object(PpoPlayerContinuous, "get_action", held):
        res = getattr(task_eval, f"eval_{name}")(CKPT[name], num_envs=S,
                                                 steps=STEPS, device="cpu")
    assert resets[0] == S
    for k, v in FIRED[name].items():
        assert ref[k] == pytest.approx(v), (k, ref[k])
    assert set(res) == set(ref)
    for k, v in ref.items():
        exact = not isinstance(v, float) or k.endswith("_rate") \
            or k.startswith("within")
        if exact:
            assert res[k] == v, (k, res[k], v)
        else:
            assert res[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k


def test_cli_runs_each_task_on_the_cpu():
    res = task_eval.main(["--task", "walk", "--checkpoint", CKPT["walk"],
                          "--num-envs", "2", "--steps", "2", "--seed", "3",
                          "--goal-range", "0.5", "--goal-range-min", "0.15",
                          "--device", "cpu"])
    assert res["goal_range"] == 0.5 and res["goal_range_min"] == 0.15
    assert np.isfinite(res["mean_min_goal_dist_m"])
    assert 0.15 - 0.1 <= res["mean_min_goal_dist_m"] <= 0.5 + 0.1


def test_rnn_eval_raises_naming_the_roadmap_item(tmp_path):
    """The recurrent walk eval (the name is kept from when this path
    raised, naming the roadmap item).  A port-written LSTM TrainState
    (`utils.checkpoint.save`) runs through the port's and the JAX package's
    `eval_walk` from the same scenario states as the MLP case above, every
    auto-reset taking env 0's state in both: the actions of every env at
    every step agree to 1e-4 (the observation bar of one control step, as
    the closed-loop ticks above; a carry not zeroed on done would show),
    and the results as in `test_eval_runs_and_returns_the_jax_keys`."""
    from bez_isaacgym_tpu.eval import task_eval as jeval
    from bez_isaacgym_tpu_torch.rl.ppo import PPOConfig
    from bez_isaacgym_tpu_torch.rl.ppo_rnn import PPORNN
    from bez_isaacgym_tpu_torch.tasks.base import tree_map
    from bez_isaacgym_tpu_torch.utils import checkpoint as tckpt

    units, seq_len = 8, 2
    jmod = sys.modules[jreg.task_map["bez_walk"].__module__]
    tmod = sys.modules[treg.task_map["bez_walk"].__module__]
    jcfg = dataclasses.replace(jmod.walk_config(), substeps=1,
                               use_pallas=False)
    tcfg = dataclasses.replace(tmod.walk_config(), substeps=1)
    jcls, tcls = jreg.task_map["bez_walk"], treg.task_map["bez_walk"]
    ttask = tcls(tcfg, device="cpu")
    ppo = PPORNN(ttask, S, PPOConfig(rnn_units=units, seq_len=seq_len,
                                     horizon=seq_len))
    ckpt = str(tmp_path / "walk_lstm.ckpt")
    tckpt.save(ckpt, ppo.init(torch.Generator().manual_seed(5)))

    jtask = jcls(jcfg)
    keys = jax.random.split(jax.random.PRNGKey(0), S)
    st = jax.tree.map(np.array, jax.jit(jax.vmap(jtask.reset_one))(keys))
    st = _scenarios("walk", st, jtask, _fallen(tcls, tcfg))
    table, table_keys = jax.tree.map(jnp.asarray, st), jnp.asarray(keys)

    def jax_reset_one(self, rkey, dr_step=0):
        i = jnp.argmax(jnp.all(rkey == table_keys, axis=-1))
        return jax.tree.map(lambda a: a[i], table)

    jacts, tacts = [], []
    real_jstep, real_tstep = jcls.step_batch, tcls.step_batch

    def jstep(self, states, actions):
        jax.debug.callback(lambda a: jacts.append(np.asarray(a)), actions,
                           ordered=True)
        return real_jstep(self, states, actions)

    with mock.patch.object(jmod, "walk_config", lambda: jcfg), \
            mock.patch.object(jcls, "reset_one", jax_reset_one), \
            mock.patch.object(jcls, "step_batch", jstep):
        ref = jeval.eval_walk(ckpt, S, STEPS, 0, rnn_units=units,
                              seq_len=seq_len)
        jax.effects_barrier()

    first = convert.env_state(st)
    env0 = tree_map(lambda x: x[:1], first)

    def port_reset(self, gen, n, dr_step=0):
        return first if not tacts else tree_map(
            lambda x: x.expand((n,) + x.shape[1:]).clone(), env0)

    def tstep(self, states, actions, gen):
        tacts.append(actions.numpy().copy())
        return real_tstep(self, states, actions, gen)

    with mock.patch.object(tmod, "walk_config", lambda: tcfg), \
            mock.patch.object(tcls, "reset", port_reset), \
            mock.patch.object(tcls, "step_batch", tstep):
        res = task_eval.eval_walk(ckpt, num_envs=S, steps=STEPS,
                                  rnn_units=units, seq_len=seq_len,
                                  device="cpu")
    assert len(tacts) == len(jacts) == STEPS
    np.testing.assert_allclose(np.stack(tacts), np.stack(jacts), atol=1e-4)
    # Episodes ended (and restarted with a zero carry) inside the run.
    assert ref["episodes_finished"] >= 2, ref
    assert set(res) == set(ref) and res["rnn_units"] == units
    for k, v in ref.items():
        exact = not isinstance(v, float) or k.endswith("_rate")
        if exact:
            assert res[k] == v, (k, res[k], v)
        else:
            assert res[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k


def test_rnn_cli_takes_the_seq_len(tmp_path):
    from bez_isaacgym_tpu_torch.rl.ppo import PPOConfig
    from bez_isaacgym_tpu_torch.rl.ppo_rnn import PPORNN
    from bez_isaacgym_tpu_torch.utils import checkpoint as tckpt

    task = treg.make_task("bez_walk", dataclasses.replace(
        treg.default_configs["bez_walk"](), substeps=1), device="cpu")
    ppo = PPORNN(task, 2, PPOConfig(rnn_units=4, seq_len=3, horizon=3))
    ckpt = str(tmp_path / "walk_lstm.ckpt")
    tckpt.save(ckpt, ppo.init(torch.Generator().manual_seed(0)))
    res = task_eval.main(["--task", "walk", "--checkpoint", ckpt,
                          "--num-envs", "2", "--steps", "2", "--rnn-units",
                          "4", "--seq-len", "3", "--device", "cpu"])
    assert res["rnn_units"] == 4 and np.isfinite(res["mean_min_goal_dist_m"])
    with pytest.raises(ValueError, match="parameters"):
        task_eval.main(["--task", "walk", "--checkpoint", CKPT["walk"],
                        "--rnn-units", "4", "--num-envs", "2", "--device",
                        "cpu"])
