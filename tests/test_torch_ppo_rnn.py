"""Recurrent PPO (`bez_isaacgym_tpu_torch/rl/ppo_rnn.py`) against the JAX
package's `make_ppo_rnn` on the CPU.

One train_iter in each package from the same TrainState, start states,
carry and draws (`tests/torch_ppo_parity.py`): S = 4 envs, horizon 4 in
windows of seq_len 2 (8 sequences), minibatch 6 steps = 3 sequences (2
minibatches, the remainder dropped), 2 mini-epochs, LSTM 8 units, units
(16, 16), substeps 1.  Episodes end by time-out at the window's last step
(env 1), at the first step (env 2: the carry is zeroed inside the first
window) and at the third (env 3: the first step of the second window);
each restarts from the same fixed reset state in both packages.
Tolerances as in tests/test_torch_ppo.py: the rollout, carry, GAE and
running stats 1e-5 relative and absolute (observations 1e-4 absolute), the
loss terms and each minibatch's KL 2e-5 relative, parameters within twice
the sum of the steps' learning rates.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_ppo_parity as P  # noqa: E402
from bez_isaacgym_tpu.rl import ppo as jppo  # noqa: E402
from bez_isaacgym_tpu.rl import ppo_rnn as jrnn  # noqa: E402
from bez_isaacgym_tpu_torch.rl import ppo as tppo  # noqa: E402
from bez_isaacgym_tpu_torch.rl import ppo_rnn as trnn  # noqa: E402

H, L, MB, EPOCHS, UNITS = 4, 2, 6, 2, 8
ENDS = {1: H, 2: 1, 3: 3}
OBS_ATOL = P.OBS_ATOL


def _cfg(module):
    return module.PPOConfig(horizon=H, seq_len=L, rnn_units=UNITS,
                            minibatch_size=MB, mini_epochs=EPOCHS,
                            units=(16, 16))


@pytest.fixture(scope="module")
def run():
    jtask, ttask = P.tasks()
    (jst, jobs), (tst, tobs), table = P.start(jtask, ENDS)
    init, train_iter, jact, jcarry = jrnn.make_ppo_rnn(jtask, P.S,
                                                       _cfg(jppo))
    jts = init(jax.random.PRNGKey(0))
    ts = P.port_state(jts)
    noise, perms = P.draws(jts.key, H, P.S * H // L, EPOCHS)
    ppo = trnn.PPORNN(ttask, P.S, _cfg(tppo))
    gen = torch.Generator().manual_seed(0)
    with P.fixed_resets(jtask, ttask, table):
        jout, taps = P.jax_train_iter(jrnn, "TransitionRNN", train_iter,
                                      jts, jst, jobs, jcarry(P.S))
        with P.port_kl_tap() as kls:
            out = ppo.train_iter(ts, tst, tobs, ppo.initial_carry(), gen,
                                 noise, perms)
        rollout = ppo.rollout(ts, tst, tobs, ppo.initial_carry(), gen, noise)
    return dict(ppo=ppo, ts=ts, jts=jts, jout=jout, taps=taps, out=out,
                kls=kls, rollout=rollout, jact=jact, jobs=jobs, tobs=tobs)


def test_rollout_and_carry_match_jax(run):
    *_, traj = run["rollout"]
    steps = run["taps"]["steps"]
    for f in trnn.TransitionRNN._fields:
        P.assert_close(getattr(traj, f).numpy(), getattr(steps, f), 1e-5,
                       OBS_ATOL if f == "obs" else 1e-5, f)
    done = steps.done.astype(bool)
    assert done[H - 1, 1] and done[0, 2] and done[2, 3]
    assert done.sum() == 3


def test_carry_is_zeroed_on_done(run):
    """The carry entering the step after an episode's end is zero, and
    nonzero elsewhere after the first step."""
    *_, traj = run["rollout"]
    norm = (traj.carry_h.abs().sum(-1) + traj.carry_c.abs().sum(-1)).numpy()
    assert np.all(norm[0] == 0)              # the initial carry
    assert norm[1, 2] == 0 and norm[3, 3] == 0
    live = np.ones_like(norm, bool)
    live[0], live[1, 2], live[3, 3] = False, False, False
    assert np.all(norm[live] > 0)


def test_final_carry_and_state_match_jax(run):
    _, jst2, jobs2, jcarry2, _ = run["jout"]
    _, tst2, tobs2, tcarry2, _ = run["out"]
    for t, j in zip(tcarry2, jcarry2):
        P.assert_close(t.numpy(), j, 1e-5, 1e-5, "carry")
    # Env 1 ended at the last step: its carry is zero for the next window.
    assert float(tcarry2[0][1].abs().sum()) == 0.0
    P.assert_close(tobs2.numpy(), jobs2, 1e-5, OBS_ATOL, "last_obs")
    P.assert_close(tst2.physics.q.numpy(), np.asarray(jst2.physics.q), 1e-5,
                   1e-5, "q")


def test_returns_and_running_stats_match_jax(run):
    obs_b, ret_b = run["taps"]["rms"]
    *_, traj = run["rollout"]
    P.assert_close(traj.obs.reshape(-1, 54).numpy(), obs_b, 1e-5, OBS_ATOL,
                   "obs batch")
    ppo, ts = run["ppo"], run["ts"]
    _, _, carry2, _ = run["rollout"]
    ts1 = ppo._update_obs_rms(ts, traj)
    _, ret = ppo.compute_gae(ts1, traj, run["rollout"][1], carry2)
    P.assert_close(ret.numpy(), ret_b, 1e-5, 1e-5, "returns")
    jsd, ts2 = P.port_state(run["jout"][0]), run["out"][0]
    for name in ("obs_rms", "value_rms"):
        for f in ("mean", "var", "count"):
            P.assert_close(getattr(getattr(ts2, name), f).numpy(),
                           getattr(getattr(jsd, name), f).numpy(), 1e-5,
                           1e-5, f"{name}.{f}")


def test_update_losses_kl_and_lr_match_jax(run):
    m, jm = run["out"][4], run["jout"][4]
    assert len(run["kls"]) == len(run["taps"]["kl"]) == 2 * EPOCHS
    P.assert_close(run["kls"], run["taps"]["kl"], 2e-5, 1e-7,
                   "each minibatch's KL")
    assert set(m) == set(jm)
    for k in m:
        P.assert_close(float(m[k]), float(jm[k]), 2e-5, 1e-7, k)


def test_params_and_adam_state_match_jax(run):
    ts2, jsd = run["out"][0], P.port_state(run["jout"][0])
    cfg, lr, lrs = run["ppo"].cfg, run["ts"].lr, []
    for kl in run["taps"]["kl"]:
        lr = tppo.adapt_lr(lr, torch.tensor(float(kl)), cfg)
        lrs.append(float(lr))
    assert any(k.startswith("cell.") for k in ts2.params)
    for k, v in ts2.params.items():
        P.assert_close(v.numpy(), jsd.params[k].numpy(), 0, 2 * sum(lrs), k)
        assert not torch.equal(v, run["ts"].params[k]), f"{k} did not move"
        want = jsd.opt_state.mu[k].numpy()
        P.assert_close(ts2.opt_state.mu[k].numpy(), want, 1e-3,
                       1e-4 * float(np.abs(want).max()) + 1e-12, f"mu {k}")
    assert int(ts2.opt_state.count) == 2 * EPOCHS
    assert float(ts2.lr) == pytest.approx(lrs[-1], rel=1e-6)


def test_sequence_layout_is_env_major_windows():
    """(H, N) -> (N*W, L): sequence n*W + w is env n's window w."""
    ppo = trnn.PPORNN.__new__(trnn.PPORNN)
    ppo.cfg = _cfg(tppo)
    x = torch.arange(H * P.S).reshape(H, P.S)        # x[t, n] = t*S + n
    seq = ppo._to_sequences(x)
    assert seq.shape == (P.S * H // L, L)
    for n in range(P.S):
        for w in range(H // L):
            assert seq[n * (H // L) + w].tolist() == \
                [(w * L + i) * P.S + n for i in range(L)]


def test_act_matches_jax(run):
    ts, ppo = run["ts"], run["ppo"]
    carry = tuple(0.1 * torch.randn((P.S, UNITS),
                                    generator=torch.Generator().manual_seed(3))
                  for _ in range(2))
    a, c = ppo.act(ts, run["tobs"], carry)
    ja, jc = run["jact"](run["jts"], run["jobs"],
                         tuple(jnp.asarray(x.numpy()) for x in carry))
    P.assert_close(a.numpy(), ja, 1e-5, 1e-6, "action")
    for t, j in zip(c, jc):
        P.assert_close(t.numpy(), j, 1e-5, 1e-6, "carry")
    assert ppo.initial_carry()[0].shape == (P.S, UNITS)
    assert ppo.initial_carry(7)[1].shape == (7, UNITS)


def test_config_is_refused_where_the_jax_package_asserts():
    jtask, ttask = P.tasks()
    with pytest.raises(ValueError, match="multiple"):
        trnn.PPORNN(ttask, P.S, tppo.PPOConfig(rnn_units=8, horizon=5,
                                               seq_len=2))
    with pytest.raises(ValueError, match="rnn_units"):
        trnn.PPORNN(ttask, P.S, tppo.PPOConfig())
