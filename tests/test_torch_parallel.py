"""The port's data-parallel layer (`bez_isaacgym_tpu_torch/parallel/`)
against the JAX package's `parallel/` on the CPU.

Two ranks are spawned once for the module (gloo, `tests/torch_dp_worker.py`)
at `tests/mp_worker.py`'s shape: 16 global envs, horizon 2, units (16, 16),
substeps 1; minibatch 16 global (8 per rank, 2 minibatches) and 2
mini-epochs.  The JAX side runs `shard_map` on 2 of conftest's 8 virtual
CPU devices.  Both start from the same TrainState and states, every
auto-reset takes env 0's start state, and each rank gets the draws of its
JAX shard: noise and permutations rebuilt from `fold_in(key, shard)`'s
chain (`tests/torch_ppo_parity.py`).  Tolerances:

- the running-stat and advantage moments 1e-6 relative (f32 sums of 8-32
  terms, measured about 1e-7);
- one iteration against the JAX one: tests/test_torch_ppo.py's, the losses
  and each minibatch's KL 2e-5 relative, the running stats 1e-5 (the
  observations' at the observations' own 1e-4 absolute: 16 envs' stats
  differ by up to 1.7e-5), parameters within twice the sum of the steps'
  learning rates;
- the ranks bit-identical;
- one iteration against the single-process port update on the
  concatenated shards (each minibatch the union of the ranks'): f32
  summation order only: each step's gradients 1e-5 relative in norm,
  each minibatch's KL 1e-5 relative (measured 1.7e-6), Adam's
  moments 1e-4 in norm (8e-6), the running stats 1e-5 (2.5e-6 on the
  returns', which see the last value through the observation stats), the
  learning rate equal.  Adam divides each gradient by its own RMS, so a
  gradient element at the sums' f32 noise may differ in sign and move its
  parameter by up to its learning rate the other way: the parameters are
  held within twice the sum of the steps' learning rates, as above
  (measured 0.3% of it).
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.shard_map import shard_map  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as PS  # noqa: E402

import torch_dp_worker  # noqa: E402
import torch_ppo_parity as P  # noqa: E402
from bez_isaacgym_tpu.parallel import distributed as jdist  # noqa: E402
from bez_isaacgym_tpu.parallel.dp import data_parallel_ppo  # noqa: E402
from bez_isaacgym_tpu.parallel.mesh import env_mesh  # noqa: E402
from bez_isaacgym_tpu.rl import networks as jnet  # noqa: E402
from bez_isaacgym_tpu.rl import ppo as jppo  # noqa: E402
from bez_isaacgym_tpu.rl import ppo_rnn as jrnn  # noqa: E402
from bez_isaacgym_tpu_torch.parallel import distributed  # noqa: E402
from bez_isaacgym_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from bez_isaacgym_tpu_torch.rl import ppo as tppo  # noqa: E402
from bez_isaacgym_tpu_torch.rl import ppo_rnn as trnn  # noqa: E402

RANKS, N, H, MB, EPOCHS = 2, 16, 2, 16, 2
NL = N // RANKS
ENDS = {1: H, 9: 1}           # an episode ends in each rank's shard
CASES = {"mlp": {}, "lstm": {"rnn_units": 8, "seq_len": 2}}


def _cfg(module, case):
    return module.PPOConfig(horizon=H, minibatch_size=MB, mini_epochs=EPOCHS,
                            units=(16, 16), **CASES[case])


@pytest.fixture(scope="module")
def jmesh():
    return env_mesh(jax.devices("cpu")[:RANKS])


@pytest.fixture(scope="module")
def moments():
    rng = np.random.default_rng(0)
    return {"batch": (3.0 + 2.0 * rng.standard_normal((N * H, 54))
                      ).astype(np.float32),
            "returns": rng.standard_normal(N * H).astype(np.float32),
            "adv": (0.5 + rng.standard_normal(N * H)).astype(np.float32)}


def _case_inputs(case):
    """The JAX side's TrainState, start states and each shard's draws, and
    the same carried across to the port."""
    jtask, _ = P.tasks()
    (jst, jobs), (tst, tobs), table = P.start(jtask, ENDS, N)
    recurrent = "rnn_units" in CASES[case]
    jcfg = _cfg(jppo, case)
    n_items = NL * H // jcfg.seq_len if recurrent else NL * H
    make = jrnn.make_ppo_rnn if recurrent else jppo.make_ppo
    jts = make(jtask, N, jcfg)[0](jax.random.PRNGKey(0))
    noise, perms = zip(*[P.draws(jax.random.fold_in(jts.key, r), H, n_items,
                                 EPOCHS, NL) for r in range(RANKS)])
    return dict(jtask=jtask, jts=jts, jst=jst, jobs=jobs, table=table,
                ts=P.port_state(jts), tst=tst, tobs=tobs,
                noise=list(noise), perms=[list(p) for p in perms],
                recurrent=recurrent)


@pytest.fixture(scope="module")
def inputs():
    return {case: _case_inputs(case) for case in CASES}


@pytest.fixture(scope="module")
def ranks(inputs, moments):
    """Every rank-side job in one spawn of 2 gloo ranks."""
    jobs = [("rms", "rms", {"batch": moments["batch"],
                            "returns": moments["returns"]}),
            ("adv", "adv", {"adv": moments["adv"],
                            "returns": moments["returns"]})]
    for case, c in inputs.items():
        first = P.convert.env_state(jax.tree.map(lambda a: a[:1], c["table"]))
        kw = dict(cfg=dataclasses.asdict(_cfg(tppo, case)), num_envs=N,
                  ts=c["ts"], env_state=c["tst"], obs=c["tobs"], first=first,
                  noise=c["noise"], perms=c["perms"])
        if c["recurrent"]:
            kw["carry"] = tuple(torch.zeros(N, 8) for _ in range(2))
        jobs.append((case, "ppo", kw))
    return distributed.spawn_ranks(torch_dp_worker.run_jobs, RANKS, jobs)


@pytest.fixture(scope="module")
def jax_dp(inputs, jmesh):
    """The JAX data_parallel_ppo iteration of each case on 2 devices."""
    out = {}
    for case, c in inputs.items():
        _, ttask = P.tasks()
        fns = data_parallel_ppo(c["jtask"], N, jmesh, _cfg(jppo, case))
        put = lambda x, spec: jax.device_put(  # noqa: E731
            x, NamedSharding(jmesh, spec))
        args = [put(c["jts"], PS()), put(c["jst"], PS("env")),
                put(c["jobs"], PS("env"))]
        if c["recurrent"]:
            args.append(put(fns[3](), PS("env")))
        with P.fixed_resets(c["jtask"], ttask, c["table"]):
            out[case] = jax.block_until_ready(fns[1](*args))
    return out


# ------------------------------------------------------------ set-up
def test_init_distributed_summary_keys_match_jax(ranks):
    want = set(jdist.init_distributed())
    assert set(distributed.init_distributed(device="cpu")) == want
    for r, res in enumerate(ranks):
        assert res["summary"] == {"process_index": r,
                                  "process_count": RANKS,
                                  "local_devices": 1,
                                  "global_devices": RANKS}


@pytest.mark.parametrize("device,local_world,cards,want", [
    ("cuda", 2, 2, "nccl"), ("cuda", 4, 8, "nccl"), ("cuda", 2, 1, "gloo"),
    ("cuda", 8, 4, "gloo"), ("cpu", 2, 0, "gloo")])
def test_backend_is_chosen_from_the_layout(device, local_world, cards, want,
                                           monkeypatch):
    """nccl with a card per rank, gloo when ranks share a card or on the
    CPU; init_distributed passes that backend and no other, and puts the
    rank on cuda:{local_rank % cards}."""
    assert distributed.choose_backend(device, local_world, cards) == want
    for k, v in {"RANK": "1", "WORLD_SIZE": str(local_world),
                 "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": str(local_world),
                 "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    seen = {}
    with mock.patch.object(torch.cuda, "device_count", return_value=cards), \
            mock.patch.object(torch.cuda, "set_device",
                              side_effect=lambda d: seen.update(dev=d)), \
            mock.patch.object(distributed.dist, "is_initialized",
                              return_value=False), \
            mock.patch.object(distributed.dist, "init_process_group",
                              side_effect=lambda b, **k: seen.update(
                                  backend=b, **k)):
        distributed.init_distributed(device=device)
    assert seen["backend"] == want and seen["world_size"] == local_world
    assert seen["init_method"] == "tcp://localhost:1"
    if device == "cuda":
        assert seen["dev"] == torch.device("cuda", 1 % cards)


def test_backend_without_a_card_raises():
    with pytest.raises(RuntimeError, match="card"):
        distributed.choose_backend("cuda", 2, 0)


def test_init_distributed_without_ranks_is_a_no_op():
    assert not distributed.dist.is_initialized()
    assert distributed.init_distributed(device="cpu")["process_count"] == 1
    assert not distributed.dist.is_initialized()


# ------------------------------------------------------------ moments
def test_running_stats_equal_jax_shard_map(ranks, moments, jmesh):
    def upd(batch, returns):
        vec = jnet.RunningMeanStd.create((54,)).update(batch, "env")
        sca = jnet.RunningMeanStd.create(()).update(returns, "env")
        return vec, sca

    want = shard_map(upd, mesh=jmesh, in_specs=(PS("env"), PS("env")),
                     out_specs=PS(), check_rep=False)(
        jnp.asarray(moments["batch"]), jnp.asarray(moments["returns"]))
    for r in ranks:
        for got, w in ((r["rms"]["vec"], want[0]),
                       (r["rms"]["scalar"], want[1])):
            for g, x in zip(got, w):
                P.assert_close(g.numpy(), np.asarray(x), 1e-6, 1e-7, "rms")
    for g0, g1 in zip(ranks[0]["rms"]["vec"], ranks[1]["rms"]["vec"]):
        assert torch.equal(g0, g1)


def test_advantage_moments_equal_jax_shard_map(ranks, moments, jmesh):
    """ppo.py:226-238 under shard_map: value_rms on the returns, then the
    pmean of the advantages' mean and of their squared deviation."""
    def norm(adv, returns):
        rms = jnet.RunningMeanStd.create(()).update(returns, "env")
        mean = jax.lax.pmean(adv.mean(), "env")
        std = jnp.sqrt(jax.lax.pmean(((adv - mean) ** 2).mean(), "env"))
        return (adv - mean) / (std + 1e-8), rms.normalize(returns), rms

    adv, ret, rms = shard_map(
        norm, mesh=jmesh, in_specs=(PS("env"), PS("env")),
        out_specs=(PS("env"), PS("env"), PS()), check_rep=False)(
        jnp.asarray(moments["adv"]), jnp.asarray(moments["returns"]))
    got_adv = torch.cat([r["adv"]["adv"] for r in ranks])
    got_ret = torch.cat([r["adv"]["returns"] for r in ranks])
    P.assert_close(got_adv.numpy(), np.asarray(adv), 1e-6, 1e-6, "adv")
    P.assert_close(got_ret.numpy(), np.asarray(ret), 1e-6, 1e-6, "returns")
    for r in ranks:
        for g, x in zip(r["adv"]["value_rms"], rms):
            P.assert_close(g.numpy(), np.asarray(x), 1e-6, 1e-7, "value_rms")


# ------------------------------------------------------------ one iteration
def _flat_state(ts):
    return [*ts.params.values(), *ts.opt_state.mu.values(),
            *ts.opt_state.nu.values(), *ts.obs_rms, *ts.value_rms, ts.lr,
            ts.opt_state.count, ts.epoch]


@pytest.mark.parametrize("case", sorted(CASES))
def test_ranks_are_bit_identical(ranks, case):
    a, b = (_flat_state(r[case]["ts"]) for r in ranks)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert ranks[0][case]["metrics"].keys() == ranks[1][case]["metrics"].keys()
    for k, v in ranks[0][case]["metrics"].items():
        assert torch.equal(v, ranks[1][case]["metrics"][k]), k
    assert ranks[0][case]["kls"] == ranks[1][case]["kls"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_iteration_equals_jax_data_parallel_ppo(ranks, jax_dp, inputs, case):
    ts2, m = ranks[0][case]["ts"], ranks[0][case]["metrics"]
    jts2, jm = jax_dp[case][0], jax_dp[case][-1]
    jsd = P.port_state(jts2)
    for k in ("loss", "a_loss", "c_loss", "entropy", "kl", "lr"):
        P.assert_close(float(m[k]), float(jm[k]), 2e-5, 1e-7, k)
    for k in ("reward_mean", "done_frac", "value_mean", "ep_reward_mean",
              "ep_len_mean", "ep_count"):
        P.assert_close(float(m[k]), float(jm[k]), 1e-5, 1e-7, k)
    assert set(m) == set(jm)
    for name in ("obs_rms", "value_rms"):
        # The observations' stats are held to the observations' own bar.
        atol = P.OBS_ATOL if name == "obs_rms" else 1e-5
        for f in ("mean", "var", "count"):
            P.assert_close(getattr(getattr(ts2, name), f).numpy(),
                           getattr(getattr(jsd, name), f).numpy(), 1e-5,
                           atol, f"{name}.{f}")
    # The learning rate of each step, from the minibatch KLs (pmeaned).
    cfg, lr, lrs = _cfg(tppo, case), inputs[case]["ts"].lr, []
    for kl in ranks[0][case]["kls"]:
        lr = tppo.adapt_lr(lr, torch.tensor(kl), cfg)
        lrs.append(float(lr))
    assert len(lrs) == 2 * EPOCHS
    atol = 2 * sum(lrs)
    for k, v in ts2.params.items():
        P.assert_close(v.numpy(), jsd.params[k].numpy(), 0, atol, k)
        assert not torch.equal(v, inputs[case]["ts"].params[k]), k
    assert int(ts2.opt_state.count) == int(jsd.opt_state.count)
    assert float(ts2.lr) == pytest.approx(float(jsd.lr), rel=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_iteration_equals_the_single_process_interleaved_update(ranks,
                                                                 inputs,
                                                                 case):
    """The port's single-process update (no group) on the concatenated
    shards: rank r's local sample (t, e) is the global t * N + r * N/2 + e
    (for sequences, env-major: rank r's sequence i is r * NL * W + i), and
    each minibatch is the union of the ranks' minibatches."""
    c = inputs[case]
    _, ttask = P.tasks()
    cfg = _cfg(tppo, case)
    ppo = (trnn.PPORNN if c["recurrent"] else tppo.PPO)(ttask, N, cfg)
    res = [r[case] for r in ranks]
    traj = type(res[0]["traj"])(*[torch.cat(x, dim=1) for x in zip(
        *[r["traj"] for r in res])])
    last_obs = torch.cat([r["last_obs"] for r in res])
    W = H // cfg.seq_len
    n_local = NL * W if c["recurrent"] else NL * H
    mb_local = (MB // RANKS) // (cfg.seq_len if c["recurrent"] else 1)
    perms = []
    for e in range(EPOCHS):
        parts = []
        for r in range(RANKS):
            loc = torch.as_tensor(c["perms"][r][e])
            glob = r * n_local + loc if c["recurrent"] else \
                (loc // NL) * N + r * NL + loc % NL
            parts.append(glob[: (n_local // mb_local) * mb_local]
                         .reshape(-1, mb_local))
        perms.append(torch.cat(parts, dim=1).reshape(-1))
    ts1 = ppo._update_obs_rms(c["ts"], traj)
    grads, real_clip = [], tppo.clip_by_global_norm

    def clip(g, max_norm):
        grads.append(g)
        return real_clip(g, max_norm)

    with P.port_kl_tap() as kls, \
            mock.patch.object(tppo, "clip_by_global_norm", clip):
        if c["recurrent"]:
            carry = tuple(torch.cat(x)
                          for x in zip(*[r["carry"] for r in res]))
            adv, ret = ppo.compute_gae(ts1, traj, last_obs, carry)
            single, _ = ppo.update(ts1, traj, adv, ret, perms=perms)
        else:
            adv, ret = ppo.compute_gae(ts1, traj, last_obs)
            flat = tppo.Transition(*[x.reshape((-1,) + x.shape[2:])
                                     for x in traj])
            single, _ = ppo.update(ts1, flat, adv.reshape(-1),
                                   ret.reshape(-1), perms=perms)
    dp = res[0]["ts"]

    def cat(d):
        return torch.cat([v.reshape(-1) for v in d.values()])

    assert len(res[0]["grads"]) == len(grads) == 2 * EPOCHS
    for g_dp, g_1 in zip(res[0]["grads"], grads):
        g_dp, g_1 = cat(g_dp), cat(g_1)
        assert float((g_dp - g_1).norm() / g_1.norm()) <= 1e-5
    P.assert_close(res[0]["kls"], kls, 1e-5, 0, "each minibatch's KL")
    lr, sum_lr = c["ts"].lr, 0.0
    for kl in kls:
        lr = tppo.adapt_lr(lr, torch.tensor(kl), cfg)
        sum_lr += float(lr)
    for k, v in single.params.items():
        P.assert_close(dp.params[k].numpy(), v.numpy(), 0, 2 * sum_lr, k)

    for mom in ("mu", "nu"):
        a, b = (cat(getattr(x.opt_state, mom)) for x in (dp, single))
        assert float((a - b).norm() / b.norm()) <= 1e-4, mom
    for name in ("obs_rms", "value_rms"):
        for a, b in zip(getattr(dp, name), getattr(single, name)):
            P.assert_close(a.numpy(), b.numpy(), 1e-5, 1e-7, name)
    assert float(dp.lr) == float(single.lr)


def test_env_sharding_and_gather_are_jax_layout():
    """A one-rank mesh: the shard is the whole batch and gathering returns
    it; rank r of 2 holds rows [r N/2, (r+1) N/2) (JAX's P("env"))."""
    x = torch.arange(16.0).reshape(8, 2)
    one = tmesh.env_mesh("cpu")
    assert one.world == 1 and one.group is None
    assert torch.equal(tmesh.env_sharding(one)(x), x)
    assert tmesh.gather_env(x, one) is x
    for r in range(2):
        m = tmesh.Mesh(r, 2, torch.device("cpu"))
        assert torch.equal(tmesh.env_sharding(m)(x), x[4 * r:4 * r + 4])
    with pytest.raises(ValueError, match="split"):
        tmesh.env_sharding(tmesh.Mesh(0, 3, torch.device("cpu")))(x)
    assert len({tmesh.rank_seed(42, r) for r in range(4)} |
               {tmesh.rank_seed(43, 0)}) == 5


def test_vec_env_sharding_steps_this_ranks_rows():
    """VecEnv(sharding=...) (the JAX `sharding` argument): every rank
    resets all the envs from the same seed and keeps its rows, so its
    first observations are its rows of the unsharded env's."""
    from bez_isaacgym_tpu_torch.envs.vec_env import VecEnv

    _, ttask = P.tasks()
    whole = VecEnv(ttask, 4, seed=3).reset()
    for r in range(2):
        env = VecEnv(ttask, 4, seed=3, sharding=tmesh.env_sharding(
            tmesh.Mesh(r, 2, torch.device("cpu"))))
        assert torch.equal(env.reset(), whole[2 * r:2 * r + 2])
        obs, rew, done, info = env.step(torch.zeros(2, 18))
        assert obs.shape == (2, 54) and rew.shape == done.shape == (2,)
