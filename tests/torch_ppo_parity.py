"""Shared set-up of the PPO parity tests (`tests/test_torch_ppo*.py`).

Both packages get the same TrainState (the JAX `init_fn(PRNGKey(0))`,
carried across with `convert.train_state`), the same start states (JAX
`reset_one`, carried across with `convert.env_state`) and the same draws:
the rollout noise and each mini-epoch's permutation, rebuilt from the JAX
key chain (`key, k_act = split(key)` per step, `key, k_perm = split(key)`
per mini-epoch) and passed to the port.  An env's auto-reset takes the
same fixed state in both packages (env 0's start state), so an episode may
end anywhere in the window.  The JAX `train_iter` runs jitted as the JAX
runner runs it; `jax.debug.callback` taps on its `Transition`,
`RunningMeanStd.update` and `gaussian_kl` hand the trajectory, the batches
the running stats fold in (observations, then returns) and each
minibatch's KL to the host.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import serialization

from bez_isaacgym_tpu.rl import networks as jnet
from bez_isaacgym_tpu.tasks.base import TaskConfig as JTaskConfig
from bez_isaacgym_tpu.tasks.kick import KickTask as JKickTask
from bez_isaacgym_tpu_torch import convert
from bez_isaacgym_tpu_torch.rl import ppo as tppo
from bez_isaacgym_tpu_torch.tasks.base import TaskConfig, tree_map
from bez_isaacgym_tpu_torch.tasks.kick import KickTask

S, NA = 4, 18
# Observations after a few control steps: 1e-4 absolute, the bar of
# tests/test_torch_kick.py for one step's observations (the IMU divides a
# velocity difference by dt); measured up to 5.8e-5.
OBS_ATOL = 1e-4


def tasks():
    return (JKickTask(JTaskConfig(substeps=1, use_pallas=False)),
            KickTask(TaskConfig(substeps=1), device="cpu"))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def start(jtask, ends: dict, n: int = S):
    """n JAX reset states (PRNGKey(0)); env i's progress set so that its
    episode ends by time-out at rollout step ends[i] (1-based); the first
    obs (observe with a zero action, as the runner does).  Returns the
    JAX (state, obs), the port's (state, obs), and the untouched reset
    states (numpy) the fixed auto-reset takes env 0 of."""
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    table = np_tree(jax.jit(jax.vmap(jtask.reset_one))(keys))
    st = jax.tree.map(np.array, table)
    for i, t in ends.items():
        st.progress[i] = jtask.cfg.max_episode_length - t
    obs, st = jax.jit(jax.vmap(lambda s: jtask.observe(
        s, jnp.zeros(NA, jnp.float32))))(jax.tree.map(jnp.asarray, st))
    tst = convert.env_state(np_tree(st))
    return (st, obs), (tst, torch.as_tensor(np.array(obs))), table


@contextlib.contextmanager
def fixed_resets(jtask, ttask, table):
    """Every auto-reset, in both packages, takes env 0's reset state."""
    jfirst = jax.tree.map(lambda a: jnp.asarray(a[0]), table)
    tfirst = convert.env_state(jax.tree.map(lambda a: a[:1], table))

    def jreset(self, key, dr_step=0):
        return jfirst

    def treset(self, gen, n, dr_step=0):
        return tree_map(lambda x: x.expand((n,) + x.shape[1:]).clone(),
                        tfirst)

    with mock.patch.object(type(jtask), "reset_one", jreset), \
            mock.patch.object(type(ttask), "reset", treset):
        yield


def draws(key, horizon: int, n_items: int, mini_epochs: int, n: int = S):
    """The JAX train_iter's rollout noise (H, n, NA) for n envs and
    permutations (mini_epochs, n_items), from its key chain."""
    noise, perms = [], []
    for _ in range(horizon):
        key, k = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(k, (n, NA), jnp.float32)))
    for _ in range(mini_epochs):
        key, k = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(k, n_items)))
    return torch.as_tensor(np.stack(noise)), np.stack(perms)


def port_state(jts, device="cpu"):
    """A JAX TrainState as the port's, through the checkpoint layout."""
    return convert.train_state(np_tree(serialization.to_state_dict(jts)),
                               device)


def jax_train_iter(mod, transition: str, train_iter, *args):
    """Run `train_iter(*args)` jitted with taps on `mod`'s Transition
    class and gaussian_kl and on RunningMeanStd.update.  Returns (out,
    taps): taps["steps"] the Transitions (numpy fields) in step order,
    taps["rms"] the batches folded into the running stats, taps["kl"] each
    minibatch's KL."""
    taps = {"steps": [], "rms": [], "kl": []}
    real_tr = getattr(mod, transition)
    real_update = jnet.RunningMeanStd.update
    real_kl = mod.gaussian_kl

    def tap(name, *xs):
        def put(*a):
            taps[name].append(a if len(a) > 1 else a[0])
        jax.debug.callback(lambda *a: put(*map(np.asarray, a)), *xs,
                           ordered=True)

    def tr(**kw):
        out = real_tr(**kw)
        tap("steps", *out)
        return out

    def update(self, batch, axis_name=None):
        tap("rms", batch)
        return real_update(self, batch, axis_name)

    def kl(*a):
        out = real_kl(*a)
        tap("kl", out.mean())
        return out

    with mock.patch.object(mod, transition, tr), \
            mock.patch.object(jnet.RunningMeanStd, "update", update), \
            mock.patch.object(mod, "gaussian_kl", kl):
        out = jax.block_until_ready(jax.jit(train_iter)(*args))
        jax.effects_barrier()
    taps["steps"] = real_tr(*map(np.stack, zip(*taps["steps"])))
    return out, taps


@contextlib.contextmanager
def port_kl_tap():
    """Each minibatch's KL as the port's update sees it."""
    kls = []
    real = tppo.adapt_lr

    def adapt(lr, kl, cfg):
        kls.append(float(kl))
        return real(lr, kl, cfg)

    with mock.patch.object(tppo, "adapt_lr", adapt):
        yield kls


def assert_close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)
