"""PPO (`bez_isaacgym_tpu_torch/rl/ppo.py`) against the JAX package's
`make_ppo` on the CPU.

One train_iter in each package from the same TrainState, start states and
draws (`tests/torch_ppo_parity.py`): S = 4 envs, horizon 3, minibatch 5
of 12 samples (2 minibatches, the remainder dropped), 2 mini-epochs, units
(16, 16), substeps 1; and the shipped kick TrainState resumed at full
width with its Adam moments.  Env 1 times out exactly at the window's last step
(value bootstrap, done mask, last_value x (1 - done) = 0); env 2 times out
at the first step and restarts from the fixed reset state.  Tolerances:
the rollout, GAE and running stats 1e-5 relative, 1e-5 absolute on
values of order 1 (a few control steps of the same f32 engine, measured
1e-6 and 3e-6; observations 1e-4 absolute, measured 1.7e-5); the update's loss terms and each minibatch's KL 2e-5
relative (measured 6e-6); parameters within twice the sum of the steps'
learning rates (Adam moves a parameter by about lr per step whatever its
gradient, so a gradient near zero may differ in sign between packages;
measured 1e-6).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import torch_ppo_parity as P  # noqa: E402
from bez_isaacgym_tpu.rl import ppo as jppo  # noqa: E402
from bez_isaacgym_tpu.utils import checkpoint as jckpt  # noqa: E402
from bez_isaacgym_tpu_torch.rl import ppo as tppo  # noqa: E402

H, MB, EPOCHS = 3, 5, 2
ENDS = {1: H, 2: 1}           # env -> the rollout step its episode ends at
KICK_BEST = Path(__file__).resolve().parents[1] / "runs" / "Bez_Kick" / \
    "Bez_Kick_best.ckpt"
# name -> (PPOConfig fields, a TrainState checkpoint to resume or None).
# The resumed case is the shipped kick policy at full width: Adam moments
# and count (bias corrections near 1), trained running stats, and its
# learning rate above lr_max (clipped at the first step).
CASES = {"mlp": ({}, None),
         "central_value": ({"central_value": True,
                            "central_value_units": (16, 16)}, None),
         "resume_kick_best": ({"units": (400, 200, 100), "lr_max": 2e-5},
                              KICK_BEST)}


def _cfg(extra, module):
    return module.PPOConfig(**{**dict(horizon=H, minibatch_size=MB,
                                      mini_epochs=EPOCHS, units=(16, 16)),
                               **extra})


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    """Both packages' train_iter on the same inputs, and the port's
    rollout, GAE and update called one by one."""
    extra, resume = CASES[request.param]
    jtask, ttask = P.tasks()
    (jst, jobs), (tst, tobs), table = P.start(jtask, ENDS)
    init, train_iter, _ = jppo.make_ppo(jtask, P.S, _cfg(extra, jppo))
    jts = init(jax.random.PRNGKey(0))
    if resume is not None:
        jts = jax.tree.map(jnp.asarray, jckpt.restore(str(resume), jts))
    ts = P.port_state(jts)
    noise, perms = P.draws(jts.key, H, P.S * H, EPOCHS)
    ppo = tppo.PPO(ttask, P.S, _cfg(extra, tppo))
    gen = torch.Generator().manual_seed(0)
    with P.fixed_resets(jtask, ttask, table):
        jout, taps = P.jax_train_iter(jppo, "Transition", train_iter, jts,
                                      jst, jobs)
        with P.port_kl_tap() as kls:
            out = ppo.train_iter(ts, tst, tobs, gen, noise, perms)
        env2, obs2, traj = ppo.rollout(ts, tst, tobs, gen, noise)
    ts1 = ppo._update_obs_rms(ts, traj)
    adv, ret = ppo.compute_gae(ts1, traj, obs2)
    flat = tppo.Transition(*[x.reshape((-1,) + x.shape[2:]) for x in traj])
    parts = ppo.update(ts1, flat, adv.reshape(-1), ret.reshape(-1), gen,
                       perms)
    return dict(case=request.param, ppo=ppo, ts=ts, jts=jts, jout=jout,
                taps=taps, out=out, kls=kls, traj=traj, env2=env2,
                obs2=obs2, ts1=ts1, adv=adv, ret=ret, parts=parts)


def test_rollout_matches_jax(run):
    traj, steps = run["traj"], run["taps"]["steps"]
    assert traj.obs.shape == (H, P.S, 54)
    for f in tppo.Transition._fields:
        P.assert_close(getattr(traj, f).numpy(), getattr(steps, f), 1e-5,
                       P.OBS_ATOL if f == "obs" else 1e-5, f)
    done = steps.done.astype(bool)
    # The episodes the set-up ends: env 1 at the last step, env 2 at the
    # first, both by time-out; env 2's next step swaps in the reset state
    # (progress 0) from the next step on.
    assert done[H - 1, 1] and steps.time_out[H - 1, 1]
    assert done[0, 2] and steps.time_out[0, 2]
    assert done.sum() == 2
    assert traj.ep_len[0, 2] == 900 and traj.ep_len[1, 2] == 0


def test_env_state_and_last_obs_match_jax(run):
    """The env state after the window, at tests/test_torch_engine.py's
    bars for a step of the same engine: 1e-4 on the state, contact forces
    (kn = 6000 N/m springs) 1e-3 relative + 1e-2."""
    _, jst2, jobs2, _ = run["jout"]
    P.assert_close(run["obs2"].numpy(), jobs2, 1e-5, P.OBS_ATOL, "last_obs")
    j = P.np_tree(jst2)
    for f in run["env2"].physics._fields:
        contact = f in ("sensor_normal", "body_contact_force")
        P.assert_close(getattr(run["env2"].physics, f).numpy(),
                       getattr(j.physics, f), 1e-3 if contact else 1e-5,
                       1e-2 if contact else 1e-4, f)
    for f in ("progress", "done", "ep_reward", "dr_step"):
        P.assert_close(getattr(run["env2"], f).numpy(), getattr(j, f), 1e-5,
                       1e-6, f)


def test_gae_and_running_stats_match_jax(run):
    """The batches the JAX stats fold in: the observations, then the
    returns (before they are normalized); the advantages are the returns
    less the values in the old value_rms's denormalized space."""
    obs_b, ret_b = run["taps"]["rms"]
    traj, ts = run["traj"], run["ts"]
    P.assert_close(traj.obs.reshape(-1, 54).numpy(), obs_b, 1e-5,
                   P.OBS_ATOL, "obs batch")
    P.assert_close(run["ret"].reshape(-1).numpy(), ret_b, 1e-5, 1e-5,
                   "returns")
    values = ts.value_rms.denormalize(torch.as_tensor(
        run["taps"]["steps"].value))
    P.assert_close(run["adv"].numpy(), ret_b.reshape(H, P.S) - values.numpy(),
                   1e-5, 1e-5, "advantages")
    jsd = P.port_state(run["jout"][0])
    ts2 = run["out"][0]
    for name in ("obs_rms", "value_rms"):
        for f in ("mean", "var", "count"):
            P.assert_close(getattr(getattr(ts2, name), f).numpy(),
                           getattr(getattr(jsd, name), f).numpy(), 1e-5,
                           1e-5, f"{name}.{f}")


def test_time_out_at_the_last_step_is_bootstrapped(run):
    """value_bootstrap adds gamma * V to the reward of a timed-out step:
    with it off, the returns change by that term at the two time-outs and
    by its GAE discount (gamma tau)^k at the k-th step before, in the same
    episode, and nowhere else; the last_value of env 1 (done at the last
    step) reaches nothing."""
    ppo, ts1, traj = run["ppo"], run["ts1"], run["traj"]
    cfg = ppo.cfg
    ppo.cfg = dataclasses.replace(cfg, value_bootstrap=False)
    try:
        _, ret_off = ppo.compute_gae(ts1, traj, run["obs2"])
    finally:
        ppo.cfg = cfg
    v = ts1.value_rms.denormalize(traj.value).numpy()
    want = np.zeros((H, P.S))
    for t in range(H):
        want[t, 1] = (cfg.gamma * cfg.tau) ** (H - 1 - t) * cfg.gamma \
            * v[H - 1, 1]
    want[0, 2] = cfg.gamma * v[0, 2]
    P.assert_close((run["ret"] - ret_off).numpy(), want, 1e-5, 1e-7,
                   "returns with bootstrap less returns without")
    _, ret_far = ppo.compute_gae(ts1, traj, run["obs2"] + 100.0)
    assert torch.equal(ret_far[:, 1], run["ret"][:, 1])
    assert not torch.equal(ret_far[:, 0], run["ret"][:, 0])


def test_update_losses_kl_and_lr_match_jax(run):
    m, jm = run["out"][3], run["jout"][3]
    assert len(run["kls"]) == len(run["taps"]["kl"]) == 2 * EPOCHS
    P.assert_close(run["kls"], run["taps"]["kl"], 2e-5, 1e-7,
                   "each minibatch's KL")
    for k in ("loss", "a_loss", "c_loss", "entropy", "kl", "lr"):
        P.assert_close(float(m[k]), float(jm[k]), 2e-5, 1e-7, k)
    for k in ("reward_mean", "done_frac", "value_mean", "ep_reward_mean",
              "ep_len_mean", "ep_count"):
        P.assert_close(float(m[k]), float(jm[k]), 1e-5, 1e-7, k)
    assert set(m) == set(jm)


def _step_lrs(run):
    """The learning rate of each optimizer step, replayed from the JAX
    minibatch KLs."""
    cfg, lr, out = run["ppo"].cfg, run["ts"].lr, []
    for kl in run["taps"]["kl"]:
        lr = tppo.adapt_lr(lr, torch.tensor(float(kl)), cfg)
        out.append(float(lr))
    return out


def test_params_and_adam_state_match_jax(run):
    ts2, jsd = run["out"][0], P.port_state(run["jout"][0])
    atol = 2 * sum(_step_lrs(run))
    assert set(ts2.params) == set(jsd.params)
    for k, v in ts2.params.items():
        P.assert_close(v.numpy(), jsd.params[k].numpy(), 0, atol, k)
        assert not torch.equal(v, run["ts"].params[k]) or k.startswith(
            "ac.value"), f"{k} did not move"
        for mom in ("mu", "nu"):
            want = getattr(jsd.opt_state, mom)[k].numpy()
            P.assert_close(getattr(ts2.opt_state, mom)[k].numpy(), want,
                           1e-3, 1e-4 * float(np.abs(want).max()) + 1e-12,
                           f"{mom} {k}")
    assert int(ts2.opt_state.count) == int(jsd.opt_state.count) == \
        int(run["ts"].opt_state.count) + 2 * EPOCHS
    assert int(ts2.epoch) == int(jsd.epoch) == int(run["ts"].epoch) + 1
    assert float(ts2.lr) == pytest.approx(_step_lrs(run)[-1], rel=1e-6)


def test_train_iter_is_rollout_gae_and_update(run):
    ts2, m2 = run["parts"]
    ts, m = run["out"][0], run["out"][3]
    for k in ts.params:
        assert torch.equal(ts.params[k], ts2.params[k]), k
    for k in m2:
        assert torch.equal(m[k], m2[k]), k


def test_central_value_replaces_the_value_head(run):
    names = set(run["out"][0].params)
    if run["case"] == "central_value":
        assert any(k.startswith("cv.") for k in names)
        # The shared value head gets no gradient: Adam leaves it in place.
        v = run["out"][0].params["ac.value.weight"]
        assert torch.equal(v, run["ts"].params["ac.value.weight"])
    else:
        assert not any(k.startswith(("ac.", "cv.")) for k in names)


# ------------------------------------------------------------ the optimizer
def _tree(rng, scale):
    return {"a": (scale * rng.standard_normal((3, 4))).astype(np.float32),
            "b": (scale * rng.standard_normal(5)).astype(np.float32)}


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_by_global_norm_is_optaxs(scale):
    """Below the norm nothing changes; above it, g * max / |g| exactly as
    optax (not torch's clip_grad_norm_, which adds 1e-6)."""
    g = _tree(np.random.default_rng(0), scale)
    want, _ = optax.clip_by_global_norm(1.0).update(
        jax.tree.map(jnp.asarray, g), optax.EmptyState())
    got = tppo.clip_by_global_norm({k: torch.as_tensor(v)
                                    for k, v in g.items()}, 1.0)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=0)


def test_adam_is_optaxs_scale_by_adam():
    """Five steps of scale_by_adam from zero moments: updates and state."""
    rng = np.random.default_rng(1)
    tx = optax.scale_by_adam()
    params = _tree(rng, 1.0)
    jstate = tx.init(jax.tree.map(jnp.asarray, params))
    tstate = tppo.AdamState(torch.zeros((), dtype=torch.int32),
                            {k: torch.zeros(v.shape) for k, v in
                             params.items()},
                            {k: torch.zeros(v.shape) for k, v in
                             params.items()})
    for step in range(5):
        g = _tree(rng, 0.1 * (step + 1))
        ju, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate)
        tu, tstate = tppo.adam_update({k: torch.as_tensor(v)
                                       for k, v in g.items()}, tstate)
        for k in g:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(tstate.nu[k].numpy(),
                                       np.asarray(jstate.nu[k]), rtol=1e-5)
    assert int(tstate.count) == int(jstate.count) == 5


@pytest.mark.parametrize("kl,factor", [(0.1, 1 / 1.5), (0.001, 1.5),
                                       (0.008, 1.0)])
def test_adaptive_lr_follows_this_minibatchs_kl(kl, factor):
    cfg = tppo.PPOConfig()
    lr = torch.tensor(1e-4)
    assert float(tppo.adapt_lr(lr, torch.tensor(kl), cfg)) == \
        pytest.approx(1e-4 * factor, rel=1e-6)
    assert float(tppo.adapt_lr(torch.tensor(1e-2), torch.tensor(1e-6),
                               cfg)) == pytest.approx(cfg.lr_max)
    assert float(tppo.adapt_lr(torch.tensor(1e-6), torch.tensor(1.0),
                               cfg)) == pytest.approx(1e-6)


def test_config_fields_are_the_jax_packages():
    jf = {f.name: f.default for f in dataclasses.fields(jppo.PPOConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tppo.PPOConfig)}
    assert tf == jf
