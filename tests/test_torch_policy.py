"""The port's networks and players against the JAX package's.

Weights come across from flax: the trained kick checkpoint read by the
port's reader, or random flax initializations converted with
`bez_isaacgym_tpu_torch.convert`.  Observations are drawn with numpy from a
seed and fed to both sides.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from bez_isaacgym_tpu.rl import networks as jnet  # noqa: E402
from bez_isaacgym_tpu.tasks.base import TaskConfig as JTaskConfig  # noqa: E402
from bez_isaacgym_tpu.tasks.kick import KickTask as JKickTask  # noqa: E402
from bez_isaacgym_tpu_torch import convert  # noqa: E402
from bez_isaacgym_tpu_torch.rl import networks as tnet  # noqa: E402
from bez_isaacgym_tpu_torch.rl import players as tplayers  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.base import TaskConfig  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.kick import KickTask  # noqa: E402
from bez_isaacgym_tpu_torch.utils.checkpoint import read_msgpack  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KICK = ROOT / "runs" / "Bez_Kick" / "Bez_Kick_best.ckpt"
LSTM = ROOT / "runs" / "Bez_Kick_LSTM" / "Bez_Kick_LSTM_best.ckpt"
B = 8


def _obs(seed, n=54, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=(B, n))
            ).astype(np.float32)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_actor_critic_on_the_kick_checkpoint_matches_flax():
    variables = serialization.msgpack_restore(KICK.read_bytes())["params"]
    obs = _obs(0)
    jmu, jls, jv = jnet.ActorCritic(num_actions=18).apply(
        variables, jnp.asarray(obs))
    net = tnet.ActorCritic(54, 18)
    net.load_state_dict(convert.actor_critic(
        read_msgpack(str(KICK))["params"]))
    with torch.no_grad():
        mu, ls, v = net(_t(obs))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), atol=1e-5)
    np.testing.assert_allclose(ls.detach().numpy(), np.asarray(jls), atol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5)


def test_central_value_matches_flax():
    jm = jnet.CentralValue()
    variables = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 54)))
    obs = _obs(1)
    net = tnet.CentralValue(54)
    net.load_state_dict(convert.central_value(
        jax.tree.map(np.asarray, variables)))
    with torch.no_grad():
        v = net(_t(obs))
    np.testing.assert_allclose(v.numpy(), np.asarray(jm.apply(
        variables, jnp.asarray(obs))), atol=1e-5)


@pytest.mark.parametrize("source", ["random_init", "checkpoint"])
def test_actor_critic_lstm_three_steps_match_flax(source):
    jm = jnet.ActorCriticLSTM(num_actions=18)
    if source == "checkpoint":
        variables = serialization.msgpack_restore(LSTM.read_bytes())["params"]
    else:
        variables = jax.tree.map(np.asarray, jm.init(
            jax.random.PRNGKey(2), jnp.zeros((1, 54)), jm.initial_carry(1)))
    net = tnet.ActorCriticLSTM(54, 18)
    net.load_state_dict(convert.lstm(variables))
    jcarry, tcarry = jm.initial_carry(B), net.initial_carry(B)
    rng = np.random.default_rng(3)
    for _ in range(3):
        obs = rng.normal(size=(B, 54)).astype(np.float32)
        jcarry, jmu, jls, jv = jm.apply(variables, jnp.asarray(obs), jcarry)
        with torch.no_grad():
            tcarry, mu, ls, v = net(_t(obs), tcarry)
        np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), atol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5)
        np.testing.assert_array_equal(ls.detach().numpy(), np.asarray(jls))
        for t, j in zip(tcarry, jcarry):       # (c, h)
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)


def test_running_mean_std_matches_jax():
    rng = np.random.default_rng(4)
    jr, tr = jnet.RunningMeanStd.create((5,)), tnet.RunningMeanStd.create((5,))
    for n in (7, 16):
        batch = (3.0 + 2.0 * rng.normal(size=(n, 5))).astype(np.float32)
        jr, tr = jr.update(jnp.asarray(batch)), tr.update(_t(batch))
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(tr, f).numpy(),
                                       np.asarray(getattr(jr, f)), rtol=1e-6)
    x = (3.0 + 40.0 * rng.normal(size=(B, 5))).astype(np.float32)
    np.testing.assert_allclose(tr.normalize(_t(x)).numpy(),
                               np.asarray(jr.normalize(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tr.denormalize(_t(x)).numpy(),
                               np.asarray(jr.denormalize(jnp.asarray(x))),
                               rtol=1e-6)
    # Scalar statistics over a (T, N) batch, as the value normalizer.
    batch = rng.normal(size=(4, 6)).astype(np.float32)
    js = jnet.RunningMeanStd.create(()).update(jnp.asarray(batch))
    ts = tnet.RunningMeanStd.create(()).update(_t(batch))
    np.testing.assert_allclose(ts.var.numpy(), np.asarray(js.var), rtol=1e-6)
    assert convert.running_mean_std(jax.tree.map(np.asarray, js)).count \
        == ts.count


def test_gaussian_logp_and_kl_match_jax():
    rng = np.random.default_rng(5)
    mu1, mu2, a = (rng.normal(size=(B, 18)).astype(np.float32)
                   for _ in range(3))
    ls1, ls2 = (rng.uniform(-1, 0.5, (B, 18)).astype(np.float32)
                for _ in range(2))
    np.testing.assert_allclose(
        tnet.gaussian_logp(_t(mu1), _t(ls1), _t(a)).numpy(),
        np.asarray(jnet.gaussian_logp(mu1, ls1, a)), rtol=1e-6)
    np.testing.assert_allclose(
        tnet.gaussian_kl(_t(mu1), _t(ls1), _t(mu2), _t(ls2)).numpy(),
        np.asarray(jnet.gaussian_kl(mu1, ls1, mu2, ls2)), rtol=1e-6)


@pytest.fixture(scope="module")
def tasks():
    return (JKickTask(JTaskConfig(substeps=1, use_pallas=False)),
            KickTask(TaskConfig(substeps=1), device="cpu"))


def test_ppo_player_get_action_matches_the_jax_player(tasks):
    from bez_isaacgym_tpu.rl.players import PpoPlayerContinuous as JPlayer

    jtask, ttask = tasks
    jp = JPlayer(jtask, checkpoint_path=str(KICK))
    tp = tplayers.PpoPlayerContinuous(ttask, checkpoint_path=str(KICK),
                                      device="cpu")
    # Raw observations at the scale of the obs normalizer's statistics, so
    # some normalized entries clip at +-5 and some actions at +-1.
    rms = tp.obs_rms
    obs = (rms.mean.numpy() + 3.0 * np.sqrt(rms.var.numpy())
           * _obs(6)).astype(np.float32)
    ja = np.asarray(jp.get_action(obs, deterministic=True))
    ta = tp.get_action(_t(obs), deterministic=True).numpy()
    np.testing.assert_allclose(ta, ja, atol=1e-5)
    assert (np.abs(ta) == 1.0).any() and (np.abs(ta) < 1.0).any()
    # Sampling adds exp(log_std) times the generator's normals.
    gen = torch.Generator().manual_seed(9)
    z = torch.randn((B, 18), generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        mu, log_std, _ = tp.net(tp.obs_rms.normalize(_t(obs)))
    torch.testing.assert_close(
        tp.get_action(_t(obs), deterministic=False, gen=gen),
        (mu + torch.exp(log_std) * z).clamp(-1, 1))


@pytest.mark.parametrize("actions_num", [5, (3, 4)], ids=["single", "multi"])
def test_discrete_player_matches_jax_on_converted_params(actions_num,
                                                         tmp_path):
    from bez_isaacgym_tpu.rl.players import PpoPlayerDiscrete as JPlayer

    jp = JPlayer(num_obs=10, actions_num=actions_num, seed=3)
    rng = np.random.default_rng(7)
    jp.obs_rms = jp.obs_rms._replace(
        mean=jnp.asarray(rng.normal(size=10), jnp.float32),
        var=jnp.asarray(rng.uniform(0.5, 2.0, 10), jnp.float32))
    path = tmp_path / "discrete.ckpt"
    path.write_bytes(serialization.to_bytes(
        {"params": jp.params, "obs_rms": jp.obs_rms}))
    tp = tplayers.PpoPlayerDiscrete(num_obs=10, actions_num=actions_num,
                                    device="cpu")
    tp.restore(str(path))
    obs = _obs(8, n=10, scale=2.0)
    np.testing.assert_array_equal(tp.get_action(_t(obs)).numpy(),
                                  np.asarray(jp.get_action(obs)))
    dims = list(actions_num) if isinstance(actions_num, tuple) \
        else [actions_num]
    masks = [rng.uniform(size=(B, d)) < 0.5 for d in dims]
    for m in masks:
        m[:, 0] = True                       # at least one legal action
    arg = masks if isinstance(actions_num, tuple) else masks[0]
    np.testing.assert_array_equal(
        tp.get_masked_action(_t(obs), arg).numpy(),
        np.asarray(jp.get_masked_action(obs, arg)))
    sampled = tp.get_action(_t(obs), deterministic=False,
                            gen=torch.Generator().manual_seed(0))
    assert sampled.shape == tp.get_action(_t(obs)).shape


def test_sac_player_matches_jax_on_converted_params(tasks, tmp_path):
    from bez_isaacgym_tpu.rl.players import SACPlayer as JPlayer

    jtask, ttask = tasks
    jp = JPlayer(jtask, units=(32, 16), seed=4)
    path = tmp_path / "sac.ckpt"
    path.write_bytes(serialization.to_bytes(
        {"actor": jp.actor_params, "critic": jp.critic_params,
         "critic_target": jp.critic_target_params}))
    tp = tplayers.SACPlayer(ttask, units=(32, 16), checkpoint_path=str(path),
                            device="cpu")
    obs = _obs(9, scale=3.0)
    np.testing.assert_allclose(tp.get_action(_t(obs)).numpy(),
                               np.asarray(jp.get_action(obs)), atol=1e-5)
    # The critic came across too: same Q on the same (obs, action).
    act = np.tanh(_obs(10, n=18))
    jq = jp._critic.apply(jp.critic_params, jnp.asarray(obs),
                          jnp.asarray(act))
    with torch.no_grad():
        tq = tp.critic(_t(obs), _t(act))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5)


PLAYER_CFGS = {"units_16_16": dict(units=(16, 16)),
               "central_value": dict(units=(16, 16), central_value=True,
                                     central_value_units=(16, 8)),
               "no_input_normalization": dict(units=(16, 16),
                                              normalize_input=False)}


@pytest.mark.parametrize("name", list(PLAYER_CFGS))
def test_ppo_player_serves_the_cfg_it_is_given(tasks, name, tmp_path):
    """A TrainState of a non-default PPOConfig, written by the JAX package
    (its random init, with non-trivial running statistics), served by both
    players built from that cfg: the same actions to 1e-5."""
    from bez_isaacgym_tpu.rl.players import PpoPlayerContinuous as JPlayer
    from bez_isaacgym_tpu.rl.ppo import PPOConfig as JPPOConfig
    from bez_isaacgym_tpu.utils import checkpoint as jckpt
    from bez_isaacgym_tpu_torch.rl.ppo import PPOConfig

    jtask, ttask = tasks
    kw = PLAYER_CFGS[name]
    jp = JPlayer(jtask, JPPOConfig(**kw), seed=3)
    rng = np.random.default_rng(8)
    rms = jp.train_state.obs_rms._replace(
        mean=jnp.asarray(rng.normal(size=54), jnp.float32),
        var=jnp.asarray(rng.uniform(0.5, 4.0, size=54), jnp.float32))
    jp.train_state = jp.train_state._replace(obs_rms=rms)
    path = tmp_path / "ts.ckpt"
    jckpt.save(str(path), jp.train_state)
    tp = tplayers.PpoPlayerContinuous(ttask, PPOConfig(**kw),
                                      checkpoint_path=str(path), device="cpu")
    obs = 3.0 * _obs(12)
    ja = np.asarray(jp.get_action(obs, deterministic=True))
    ta = tp.get_action(_t(obs), deterministic=True).numpy()
    np.testing.assert_allclose(ta, ja, atol=1e-5)
    # Normalization is on exactly when the cfg asks for it.
    with torch.no_grad():
        raw = tp.net(_t(obs))[0].clamp(-1, 1).numpy()
    assert np.allclose(ta, raw, atol=1e-6) == (not kw.get(
        "normalize_input", True))


def test_ppo_player_serves_a_runner_checkpoint_with_other_units(tasks,
                                                                tmp_path):
    """A checkpoint the port's Runner writes with train.units=[16,16] is
    served by PpoPlayerContinuous(task, cfg) as the trainer acts, and by
    the JAX player with the same cfg."""
    from bez_isaacgym_tpu.rl.players import PpoPlayerContinuous as JPlayer
    from bez_isaacgym_tpu.rl.ppo import PPOConfig as JPPOConfig
    from bez_isaacgym_tpu_torch.rl.ppo import PPOConfig
    from bez_isaacgym_tpu_torch.rl.runner import Runner
    from bez_isaacgym_tpu_torch.utils.config import parse_overrides

    runner = Runner(parse_overrides([
        "num_envs=4", "train.horizon=2", "train.minibatch_size=4",
        "train.mini_epochs=1", "task_cfg.substeps=1", "train.units=[16,16]",
        "save_frequency=1", "save_best_after=0", "device=cpu",
        f"output_dir={tmp_path}"]))
    ts = runner.train(1)
    path = next(Path(runner.run_dir).glob("*_1_rew_*.ckpt"))
    jtask, ttask = tasks
    tp = tplayers.PpoPlayerContinuous(ttask, PPOConfig(units=(16, 16)),
                                      checkpoint_path=str(path), device="cpu")
    obs = _obs(13)
    ta = tp.get_action(_t(obs))
    assert torch.equal(ta, runner.ppo.act(ts, _t(obs)))
    jp = JPlayer(jtask, JPPOConfig(units=(16, 16)), checkpoint_path=str(path))
    np.testing.assert_allclose(
        ta.numpy(), np.asarray(jp.get_action(obs, deterministic=True)),
        atol=1e-5)
    with pytest.raises(RuntimeError):
        # The default cfg's (400, 200, 100) net cannot take these weights.
        tplayers.PpoPlayerContinuous(ttask, checkpoint_path=str(path),
                                     device="cpu")


def test_ppo_player_refuses_a_recurrent_cfg(tasks):
    from bez_isaacgym_tpu_torch.rl.ppo import PPOConfig

    with pytest.raises(ValueError, match="Runner"):
        tplayers.PpoPlayerContinuous(tasks[1], PPOConfig(rnn_units=8),
                                     device="cpu")
