"""The training runner, its entry points, the config parser and the
checkpoint writer of the port, against the JAX package's on the CPU.

- `utils.checkpoint.save` writes flax's msgpack: the JAX package's
  `flax.serialization.from_bytes` loads a port-written TrainState (MLP,
  central value, LSTM) with equal leaves, and a JAX-written one read and
  written again by the port keeps its bytes;
- `parse_overrides` gives the JAX package's config, field by field, on the
  same argv;
- `Runner.train(2)` at a tiny size writes `metrics.jsonl` with the JAX
  runner's keys (run beside it at the same size) and its checkpoints, which
  the port's player, `Runner.play` and a resumed run read back;
- without a card the entry points raise, as does `multi_chip` with more
  than one card in a process torchrun did not start (the message gives the
  torchrun line), and `render` without matplotlib, before the first step.
"""

import dataclasses
import json
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
from flax import serialization  # noqa: E402

import torch_ppo_parity as P  # noqa: E402
from bez_isaacgym_tpu.rl import ppo as jppo  # noqa: E402
from bez_isaacgym_tpu.rl import ppo_rnn as jrnn  # noqa: E402
from bez_isaacgym_tpu.rl.runner import Runner as JRunner  # noqa: E402
from bez_isaacgym_tpu.utils import checkpoint as jckpt  # noqa: E402
from bez_isaacgym_tpu.utils import config as jconfig  # noqa: E402
from bez_isaacgym_tpu_torch import convert  # noqa: E402
from bez_isaacgym_tpu_torch import play as tplay  # noqa: E402
from bez_isaacgym_tpu_torch import train as ttrain  # noqa: E402
from bez_isaacgym_tpu_torch.rl import ppo as tppo  # noqa: E402
from bez_isaacgym_tpu_torch.rl.players import PpoPlayerContinuous  # noqa: E402
from bez_isaacgym_tpu_torch.rl.runner import Runner  # noqa: E402
from bez_isaacgym_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from bez_isaacgym_tpu_torch.utils import config as tconfig  # noqa: E402
from bez_isaacgym_tpu_torch.utils.seeding import set_seed  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NETS = {"mlp": {}, "central_value": {"central_value": True,
                                     "central_value_units": (16, 16)},
        "lstm": {"rnn_units": 8, "seq_len": 2, "horizon": 2}}
TINY = ["num_envs=4", "train.horizon=2", "train.minibatch_size=4",
        "train.mini_epochs=1", "task_cfg.substeps=1", "log_frequency=1",
        "save_frequency=2", "save_best_after=0"]


def _leaves_equal(a, b, path=""):
    """Equal trees: the same keys (in any order; the byte checks below
    hold the order) and leaves of equal dtype, shape and value."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _leaves_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)


def _port_trained(extra):
    """A port TrainState one train_iter away from init (non-zero Adam
    moments), with the JAX package's init_fn and template for the same
    config."""
    jtask, ttask = P.tasks()
    cfg_kw = {**dict(units=(16, 16), horizon=2, minibatch_size=4,
                     mini_epochs=1), **extra}
    gen = set_seed(0)
    if extra.get("rnn_units"):
        from bez_isaacgym_tpu_torch.rl.ppo_rnn import PPORNN
        ppo = PPORNN(ttask, P.S, tppo.PPOConfig(**cfg_kw))
        jinit = jrnn.make_ppo_rnn(jtask, P.S, jppo.PPOConfig(**cfg_kw))[0]
    else:
        ppo = tppo.PPO(ttask, P.S, tppo.PPOConfig(**cfg_kw))
        jinit = jppo.make_ppo(jtask, P.S, jppo.PPOConfig(**cfg_kw))[0]
    ts = ppo.init(gen)
    st = ttask.reset(gen, P.S)
    obs, st = ttask.observe(st, torch.zeros((P.S, P.NA)))
    if extra.get("rnn_units"):
        ts = ppo.train_iter(ts, st, obs, ppo.initial_carry(), gen)[0]
    else:
        ts = ppo.train_iter(ts, st, obs, gen)[0]
    return ts._replace(key=np.array([7, 9], np.uint32)), jinit


@pytest.mark.parametrize("net", sorted(NETS))
def test_port_checkpoint_loads_in_the_jax_package(net, tmp_path):
    ts, jinit = _port_trained(NETS[net])
    path = tmp_path / "port.ckpt"
    tckpt.save(str(path), ts)
    template = jinit(jax.random.PRNGKey(1))
    restored = jckpt.restore(str(path), template)
    assert type(restored) is type(template)
    want = P.np_tree(serialization.to_state_dict(restored))
    _leaves_equal(convert.flax_train_state(ts), want)
    assert jax.tree.structure(restored) == jax.tree.structure(template)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(template)):
        assert np.asarray(a).shape == np.asarray(b).shape
        assert np.asarray(a).dtype == np.asarray(b).dtype
    assert int(restored.opt_state[1].count) == 2      # two minibatches
    np.testing.assert_array_equal(np.asarray(restored.key), [7, 9])


@pytest.mark.parametrize("net", sorted(NETS))
def test_jax_checkpoint_through_the_port_keeps_its_bytes(net, tmp_path):
    """JAX save -> port read -> port TrainState -> port save: the same
    tree, and the same bytes."""
    jtask, _ = P.tasks()
    cfg = jppo.PPOConfig(units=(16, 16), **{**NETS[net], "horizon": 2})
    make = jrnn.make_ppo_rnn if cfg.rnn_units else jppo.make_ppo
    jts = make(jtask, P.S, cfg)[0](jax.random.PRNGKey(3))
    jpath, tpath = tmp_path / "jax.ckpt", tmp_path / "port.ckpt"
    jckpt.save(str(jpath), jts)
    tree = tckpt.read_msgpack(str(jpath))
    ts = convert.train_state(tree)
    tckpt.save(str(tpath), ts)
    _leaves_equal(tckpt.read_msgpack(str(tpath)), tree)
    assert tpath.read_bytes() == jpath.read_bytes()


@pytest.mark.parametrize("run", ["Bez_Kick", "Bez_Kick_LSTM", "Bez_Walk"])
def test_shipped_checkpoints_keep_their_bytes(run):
    raw = (ROOT / "runs" / run / f"{run}_best.ckpt").read_bytes()
    ts = convert.train_state(tckpt.unpackb(raw))
    assert tckpt.packb(convert.flax_train_state(ts)) == raw


def test_packb_is_msgpacks():
    """Every form the writer chooses, against msgpack-python's packb."""
    import msgpack

    tree = {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
                     2**32, -1, -32, -33, -128, -129, -32768, -32769,
                     -2**31, -2**31 - 1],
            "floats": [0.5, -1e300], "none": None, "flags": [True, False],
            "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256,
                     "e" * 65536],
            "bin": [b"", b"x" * 255, b"y" * 256, b"z" * 65536],
            "long": list(range(16)), "wide": {str(i): i for i in range(16)},
            "tuple": (1, "two")}
    assert tckpt.packb(tree) == msgpack.packb(tree, use_bin_type=True)
    assert tckpt.unpackb(tckpt.packb(tree))["tuple"] == [1, "two"]


@pytest.mark.parametrize("leaf", [np.zeros((2, 3), np.float32),
                                  np.float32(1.5), np.int32(7),
                                  np.arange(3, dtype=np.uint32)])
def test_array_leaves_are_flaxs(leaf):
    assert tckpt.packb({"x": leaf}) == serialization.msgpack_serialize(
        {"x": leaf})


def test_writer_refuses_what_flax_would_not_read():
    with pytest.raises(TypeError):
        tckpt.packb({"x": object()})
    with pytest.raises(ValueError):
        tckpt.packb(np.array([object()]))


# ------------------------------------------------------------------ config
ARGVS = [
    [],
    ["task=bez_walk", "num_envs=64", "seed=7", "train.horizon=16"],
    ["train.units=[64,32]", "train.lr_max=2e-5", "multi_chip=False",
     "checkpoint=runs/Bez_Kick/Bez_Kick_best.ckpt", "test=True"],
    ["task=bez_walk", "task_cfg.dr.enabled=True", "task_cfg.substeps=2"],
    ["train.rnn_units=128", "train.seq_len=4", "experiment=lstm",
     "train.central_value_units=64,32", "render=out.gif"],
    ["task_cfg.goal_range=1.0", "task=bez_goalie", "play_steps=30"],
]


def _fields(obj, prefix=""):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_fields(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = v
    return out


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "none")
def test_parse_overrides_matches_jax(argv):
    j = _fields(jconfig.parse_overrides(argv))
    t = _fields(tconfig.parse_overrides(argv))
    assert t.pop("device") == "cuda"
    # The task's engine switch: the Pallas kernel there, the CUDA kernel
    # here (on a card).
    if "task_cfg.use_pallas" in j:
        assert j.pop("task_cfg.use_pallas") is True
        assert t.pop("task_cfg.use_kernel") is True
    assert t == j
    assert tconfig.parse_overrides(argv).name == \
        jconfig.parse_overrides(argv).name


def test_parse_overrides_refuses_what_jax_refuses():
    for argv in (["nope=1"], ["train.nope=1"], ["num_envs"]):
        with pytest.raises((KeyError, ValueError)):
            jconfig.parse_overrides(argv)
        with pytest.raises((KeyError, ValueError)):
            tconfig.parse_overrides(argv)


def test_pretty_lists_every_field():
    text = tconfig.pretty(tconfig.RunConfig())
    assert "device: cuda" in text and "lr_max: 0.01" in text


# ------------------------------------------------------------------ runner
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's and the JAX package's runners, two iterations each at
    the same tiny size."""
    out = tmp_path_factory.mktemp("runs")
    port = Runner(tconfig.parse_overrides(
        TINY + ["device=cpu", f"output_dir={out / 'port'}"]))
    ts = port.train(2)
    jcfg = jconfig.parse_overrides(
        TINY + ["task_cfg.use_pallas=False", "multi_chip=False",
                f"output_dir={out / 'jax'}"])
    JRunner(jcfg).train(2)
    return dict(out=out, port=port, ts=ts)


def _jsonl(path):
    return [json.loads(s) for s in path.read_text().splitlines()]


def test_train_writes_the_jax_runners_metrics(trained):
    port = _jsonl(trained["out"] / "port" / "Bez_Kick" / "metrics.jsonl")
    jax_ = _jsonl(trained["out"] / "jax" / "Bez_Kick" / "metrics.jsonl")
    assert [r["iter"] for r in port] == [r["iter"] for r in jax_] == [1, 2]
    assert [r["frame"] for r in port] == [r["frame"] for r in jax_] == [8, 16]
    for p, j in zip(port, jax_):
        assert set(p) == set(j)
        assert all(np.isfinite(v) for v in p.values())


def test_train_writes_the_jax_runners_checkpoints(trained):
    port = sorted(p.name for p in (trained["out"] / "port" / "Bez_Kick")
                  .glob("*.ckpt"))
    jax_ = sorted(p.name for p in (trained["out"] / "jax" / "Bez_Kick")
                  .glob("*.ckpt"))
    assert "Bez_Kick_best.ckpt" in port
    assert any(n.startswith("Bez_Kick_2_rew_") for n in port)
    assert len(port) == len(jax_)
    assert tckpt.latest(str(trained["out"] / "port" / "Bez_Kick")) \
        .endswith(".ckpt")


def test_player_and_resume_read_the_runners_checkpoint(trained):
    """The saved TrainState equals the trained one; PpoPlayerContinuous
    restores it and acts as the trainer's `act`; a resumed run starts
    from it."""
    run_dir = trained["out"] / "port" / "Bez_Kick"
    path = next(run_dir.glob("Bez_Kick_2_rew_*.ckpt"))
    port, ts = trained["port"], trained["ts"]
    saved = convert.train_state(tckpt.read_msgpack(str(path)))
    for k in ts.params:
        assert torch.equal(saved.params[k], ts.params[k])
        assert torch.equal(saved.opt_state.nu[k], ts.opt_state.nu[k])
    assert int(saved.epoch) == 2
    player = PpoPlayerContinuous(port.task, checkpoint_path=str(path),
                                 device="cpu")
    obs = torch.randn((64, 54), generator=torch.Generator().manual_seed(0))
    assert torch.equal(player.get_action(obs), port.ppo.act(ts, obs))
    resumed = Runner(tconfig.parse_overrides(
        TINY + ["device=cpu", f"checkpoint={path}",
                f"output_dir={trained['out'] / 'resumed'}"]))
    ts0 = resumed._init_states()[0]
    assert torch.equal(ts0.params["mu.weight"], ts.params["mu.weight"])
    assert int(resumed.train(1).epoch) == 3


@pytest.mark.parametrize("net", ["mlp", "lstm"])
def test_play_runs_a_checkpoint(net, trained, tmp_path, capsys):
    argv = TINY + ["device=cpu", "test=True", "num_envs=3"]
    if net == "lstm":
        ts, _ = _port_trained(NETS["lstm"])
        path = tmp_path / "lstm.ckpt"
        tckpt.save(str(path), ts)
        argv += ["train.rnn_units=8", "train.seq_len=2", "train.units=[16,16]",
                 f"checkpoint={path}"]
    else:
        path = trained["out"] / "port" / "Bez_Kick" / "Bez_Kick_best.ckpt"
        argv += [f"checkpoint={path}"]
    mean = ttrain.main(argv + ["play_steps=5"])
    assert np.isfinite(mean)
    assert "played 5 steps" in capsys.readouterr().out


def test_play_zeroes_the_carry_on_done(tmp_path):
    """An env whose episode ends restarts with a zero carry: the LSTM
    play's actions after the end equal those of a fresh play from that
    env's reset state."""
    ts, _ = _port_trained(NETS["lstm"])
    path = tmp_path / "lstm.ckpt"
    tckpt.save(str(path), ts)
    runner = Runner(tconfig.parse_overrides(
        TINY + ["device=cpu", "train.rnn_units=8", "train.seq_len=2",
                "train.units=[16,16]", f"checkpoint={path}", "num_envs=2"]))
    carries = []
    real_act = runner.ppo.act

    def act(ts_, obs, carry, *a):
        carries.append(carry)
        return real_act(ts_, obs, carry, *a)

    real_step = runner.task.step_batch

    def step(states, actions, gen):
        out = real_step(states, actions, gen)
        done = torch.tensor([len(carries) == 2, False])
        return out._replace(done=done, state=out.state._replace(done=done))

    with mock.patch.object(runner.ppo, "act", act), \
            mock.patch.object(runner.task, "step_batch", step):
        runner.play(4)
    assert float(carries[2][0][0].abs().sum()) == 0.0
    assert float(carries[2][0][1].abs().sum()) > 0.0
    assert float(carries[3][0][0].abs().sum()) > 0.0


def test_launch_model_plays_on_the_cpu(trained):
    path = trained["out"] / "port" / "Bez_Kick" / "Bez_Kick_best.ckpt"
    lm = tplay.LaunchModel(str(path), num_envs=2, device="cpu")
    lm.cfg = dataclasses.replace(lm.cfg, task_cfg=dataclasses.replace(
        lm.cfg.resolved_task_cfg(), substeps=1))
    assert np.isfinite(lm.run_model(num_steps=3))


# ------------------------------------------------------- no hidden fallback
def test_entry_points_default_to_cuda():
    import inspect
    assert tconfig.RunConfig().device == "cuda"
    assert inspect.signature(tplay.LaunchModel).parameters[
        "device"].default == "cuda"


def test_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-GPU path is not taken")
    with pytest.raises(RuntimeError, match="CUDA"):
        Runner(tconfig.RunConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(TINY + [f"output_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tplay.main(TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        tplay.LaunchModel(num_envs=2).run_model(1)
    assert not any(tmp_path.iterdir())


def test_multi_chip_with_more_than_one_card_raises(monkeypatch):
    """Several cards in one process: the launch message with the torchrun
    line, never a quiet one-card run; under torchrun the ranks go on."""
    cfg = tconfig.parse_overrides(TINY)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with mock.patch.object(torch.cuda, "is_available", return_value=True), \
            mock.patch.object(torch.cuda, "device_count", return_value=4):
        with pytest.raises(RuntimeError,
                           match=r"torchrun --nproc-per-node 4 -m "
                                 r"bez_isaacgym_tpu_torch\.train"):
            tconfig.run_device(cfg)
        single = dataclasses.replace(cfg, multi_chip=False)
        assert tconfig.run_device(single).type == "cuda"
        monkeypatch.setenv("WORLD_SIZE", "4")
        assert tconfig.run_device(cfg).type == "cuda"
        monkeypatch.delenv("WORLD_SIZE")
    with mock.patch.object(torch.cuda, "is_available", return_value=True), \
            mock.patch.object(torch.cuda, "device_count", return_value=1):
        assert tconfig.run_device(cfg).type == "cuda"


def test_render_raises_naming_the_viz_item(trained):
    """Without matplotlib, render= raises an ImportError that names it
    before the first env step."""
    path = trained["out"] / "port" / "Bez_Kick" / "Bez_Kick_best.ckpt"
    runner = Runner(tconfig.parse_overrides(
        TINY + ["device=cpu", "render=episode.gif", f"checkpoint={path}"]))
    with mock.patch.dict("sys.modules", {"matplotlib": None}), \
            mock.patch.object(type(runner.task), "step_batch",
                              side_effect=AssertionError("stepped")):
        with pytest.raises(ImportError, match="matplotlib"):
            runner.play(1)


def test_set_seed_returns_a_seeded_generator():
    draws = []
    for _ in range(2):
        gen = set_seed(5)
        draws.append((torch.rand(3, generator=gen).tolist(),
                      np.random.randint(0, 10**9)))
    assert draws[0] == draws[1]
    assert gen.device.type == "cpu" and gen.initial_seed() == 5
    assert set_seed(-1).device.type == "cpu"
