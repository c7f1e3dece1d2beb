"""Carry state and parameters across from the JAX package's pytrees.

Plain numpy-in, torch-out functions: the caller hands over the JAX side's
NamedTuples / RobotModel with their leaves as numpy arrays (for example
`jax.tree.map(np.asarray, state)`), and gets the port's tensors on a given
device.  Fields are matched by name, so fields the port does not carry (the
PRNG `key` of EnvState) are dropped.  Network weights come across as
`state_dict`s from flax variable dicts (`{"params": {"Dense_0": ...}}`, as
`Module.init` returns them and checkpoints hold them), read with
`utils.checkpoint.read_msgpack` or taken from a live JAX pytree, and go
back with the `flax_*` inverses; `train_state` and `flax_train_state`
carry a whole PPO TrainState (weights, Adam moments, running stats,
learning rate, epoch) each way.  Nothing here imports the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bez_isaacgym_tpu_torch.models.robot import DynParams, RobotModel, Site
from bez_isaacgym_tpu_torch.ops.engine import PhysicsState
from bez_isaacgym_tpu_torch.rl.networks import RunningMeanStd
from bez_isaacgym_tpu_torch.rl.ppo import AdamState, TrainState
from bez_isaacgym_tpu_torch.solvers.mppi import MPPIState
from bez_isaacgym_tpu_torch.tasks.base import EnvState


def tensor(x, device="cpu") -> torch.Tensor | None:
    """numpy (or Python scalar) -> tensor; floats become float32, ints and
    bools keep their type."""
    if x is None:
        return None
    a = np.asarray(x)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.as_tensor(a.copy(), device=device)


def _by_name(cls, src, device, **nested):
    return cls(**{f: nested[f](getattr(src, f), device) if f in nested
                  else tensor(getattr(src, f), device)
                  for f in cls._fields})


def dyn_params(src, device="cpu") -> DynParams:
    return _by_name(DynParams, src, device)


def physics_state(src, device="cpu") -> PhysicsState:
    return _by_name(PhysicsState, src, device)


def env_state(src, device="cpu") -> EnvState:
    """EnvState without the PRNG key (the port draws from a Generator)."""
    return _by_name(EnvState, src, device, physics=physics_state,
                    dyn=dyn_params)


def mppi_state(src, device="cpu") -> MPPIState:
    return _by_name(MPPIState, src, device)


def robot_model(src) -> RobotModel:
    """A JAX-side RobotModel (numpy fields) as the port's RobotModel."""
    scalar = ("name", "nb", "nq", "joint_names", "body_names", "sites")
    kw = {f.name: (getattr(src, f.name) if f.name in scalar
                   else np.asarray(getattr(src, f.name)))
          for f in dataclasses.fields(RobotModel)}
    kw["sites"] = {k: Site(body=int(s.body), pos=np.asarray(s.pos),
                           rot=np.asarray(s.rot))
                   for k, s in src.sites.items()}
    return RobotModel(**kw)


# ------------------------------------------------------------------ networks
def _params(variables) -> dict:
    """The `params` collection of a flax variable dict."""
    if set(variables) != {"params"}:
        raise ValueError("expected a flax variable dict {'params': ...}, "
                         f"got keys {sorted(variables)}")
    return variables["params"]


def _dense_names(params: dict) -> list[str]:
    """Dense_0, Dense_1, ... in creation order."""
    names = [k for k in params if k.startswith("Dense_")]
    return sorted(names, key=lambda k: int(k[len("Dense_"):]))


def _dense(src: dict, name: str) -> dict:
    """A flax Dense {kernel (in, out), bias} as nn.Linear's weight (out, in)
    and bias, under `name`."""
    out = {f"{name}.weight": tensor(np.asarray(src["kernel"]).T)}
    if "bias" in src:
        out[f"{name}.bias"] = tensor(src["bias"])
    return out


def mlp(variables, names: list[str]) -> dict:
    """State dict of a flax module made only of Dense layers: the i-th
    Dense (creation order) becomes `names[i]`; the count must match."""
    params = _params(variables)
    denses = _dense_names(params)
    if len(denses) != len(names) or len(params) != len(denses):
        raise ValueError(f"flax params {sorted(params)} do not fit the "
                         f"{len(names)} layers {names}")
    sd = {}
    for src, dst in zip(denses, names):
        sd.update(_dense(params[src], dst))
    return sd


def _hidden_names(n: int) -> list[str]:
    return [f"hidden.{i}" for i in range(n)]


def actor_critic(variables) -> dict:
    """flax ActorCritic -> `rl.networks.ActorCritic` state dict: Dense_0 ..
    Dense_{n-1} hidden, Dense_n the mean head, Dense_{n+1} the value head,
    and log_std."""
    params = _params(variables)
    n = len(_dense_names(params)) - 2
    sd = mlp({"params": {k: v for k, v in params.items() if k != "log_std"}},
             _hidden_names(n) + ["mu", "value"])
    sd["log_std"] = tensor(params["log_std"])
    return sd


def central_value(variables) -> dict:
    """flax CentralValue -> `rl.networks.CentralValue` state dict."""
    n = len(_dense_names(_params(variables))) - 1
    return mlp(variables, _hidden_names(n) + ["value"])


def lstm(variables) -> dict:
    """flax ActorCriticLSTM -> `rl.networks.ActorCriticLSTM` state dict.  The
    cell's ii/if/ig/io kernels stack (in that order) into `cell.input`, its
    hi/hf/hg/ho kernels and biases into `cell.hidden`."""
    params = dict(_params(variables))
    cell = params.pop("OptimizedLSTMCell_0")
    gates = "ifgo"
    sd = actor_critic({"params": params})
    sd["cell.input.weight"] = tensor(np.concatenate(
        [np.asarray(cell[f"i{g}"]["kernel"]) for g in gates], axis=1).T)
    sd["cell.hidden.weight"] = tensor(np.concatenate(
        [np.asarray(cell[f"h{g}"]["kernel"]) for g in gates], axis=1).T)
    sd["cell.hidden.bias"] = tensor(np.concatenate(
        [np.asarray(cell[f"h{g}"]["bias"]) for g in gates]))
    return sd


def running_mean_std(src, device="cpu") -> RunningMeanStd:
    """A RunningMeanStd NamedTuple or its state dict {mean, var, count}."""
    if not isinstance(src, dict):
        src = src._asdict()
    return RunningMeanStd(*[tensor(src[f], device)
                            for f in RunningMeanStd._fields])


# --------------------------------------------------------- back to flax
def _np(x: torch.Tensor) -> np.ndarray:
    return np.array(x.detach().cpu().numpy(), order="C")


def flax_mlp(sd: dict, names: list[str]) -> dict:
    """The inverse of `mlp`: layer `names[i]` becomes Dense_i (weight
    transposed to flax's (in, out) kernel)."""
    params = {}
    for i, name in enumerate(names):
        layer = {}
        if f"{name}.bias" in sd:
            layer["bias"] = _np(sd[f"{name}.bias"])
        layer["kernel"] = _np(sd[f"{name}.weight"].T)
        params[f"Dense_{i}"] = layer
    return {"params": params}


def _n_hidden(sd: dict) -> int:
    return sum(1 for k in sd if k.startswith("hidden.")
               and k.endswith(".weight"))


def flax_actor_critic(sd: dict) -> dict:
    """The inverse of `actor_critic`."""
    out = flax_mlp(sd, _hidden_names(_n_hidden(sd)) + ["mu", "value"])
    out["params"]["log_std"] = _np(sd["log_std"])
    return out


def flax_central_value(sd: dict) -> dict:
    """The inverse of `central_value`."""
    return flax_mlp(sd, _hidden_names(_n_hidden(sd)) + ["value"])


def flax_lstm(sd: dict) -> dict:
    """The inverse of `lstm`, with flax's (sorted) key order."""
    out = flax_actor_critic({k: v for k, v in sd.items()
                             if not k.startswith("cell.")})
    w_in = sd["cell.input.weight"].chunk(4, dim=0)
    w_h = sd["cell.hidden.weight"].chunk(4, dim=0)
    b_h = sd["cell.hidden.bias"].chunk(4)
    cell = {}
    for j, g in enumerate("ifgo"):
        cell[f"h{g}"] = {"bias": _np(b_h[j]), "kernel": _np(w_h[j].T)}
        cell[f"i{g}"] = {"kernel": _np(w_in[j].T)}
    params = out["params"]
    params["OptimizedLSTMCell_0"] = dict(sorted(cell.items()))
    return {"params": dict(sorted(params.items()))}


# A network's flax tree <-> the port's state dict, by network kind.
def _kind_of_tree(params: dict) -> str:
    if set(params) == {"ac", "cv"}:
        return "cv"
    return "lstm" if "OptimizedLSTMCell_0" in _params(params) else "mlp"


def _kind_of_sd(sd: dict) -> str:
    if any(k.startswith("ac.") for k in sd):
        return "cv"
    return "lstm" if "cell.input.weight" in sd else "mlp"


def _prefixed(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def network(variables, device="cpu") -> dict:
    """A PPO network's flax parameter tree (or an Adam moment of the same
    shape) as the port's state dict on `device`: the MLP actor-critic, the
    LSTM one, or {"ac", "cv"} for the central-value option."""
    kind = _kind_of_tree(variables)
    if kind == "cv":
        sd = {f"ac.{k}": v for k, v in actor_critic(variables["ac"]).items()}
        sd.update({f"cv.{k}": v
                   for k, v in central_value(variables["cv"]).items()})
    else:
        sd = (lstm if kind == "lstm" else actor_critic)(variables)
    return {k: v.to(device) for k, v in sd.items()}


def flax_network(sd: dict) -> dict:
    """The inverse of `network`."""
    kind = _kind_of_sd(sd)
    if kind == "cv":
        return {"ac": flax_actor_critic(_prefixed(sd, "ac.")),
                "cv": flax_central_value(_prefixed(sd, "cv."))}
    return (flax_lstm if kind == "lstm" else flax_actor_critic)(sd)


def train_state(tree: dict, device="cpu") -> TrainState:
    """The JAX package's PPO TrainState, as flax writes it (a checkpoint
    read with `read_msgpack`), as the port's TrainState: the parameters,
    optax's Adam state `opt_state["1"]` (count, mu, nu; `opt_state["0"]`
    is clip_by_global_norm's empty state), the running stats, the learning
    rate, the epoch and the PRNG key."""
    opt = tree["opt_state"]
    if set(opt) != {"0", "1"} or opt["0"] != {}:
        raise ValueError("expected optax's (EmptyState, ScaleByAdamState) "
                         f"opt_state, got keys {sorted(opt)}")
    adam = opt["1"]
    return TrainState(
        params=network(tree["params"], device),
        opt_state=AdamState(
            count=torch.as_tensor(np.array(adam["count"], np.int32),
                                  device=device),
            mu=network(adam["mu"], device), nu=network(adam["nu"], device)),
        obs_rms=running_mean_std(tree["obs_rms"], device),
        value_rms=running_mean_std(tree["value_rms"], device),
        lr=tensor(tree["lr"], device),
        epoch=torch.as_tensor(np.array(tree["epoch"], np.int32),
                              device=device),
        key=np.asarray(tree["key"], np.uint32).copy())


def flax_train_state(ts: TrainState) -> dict:
    """The inverse of `train_state`: the tree `utils.checkpoint.save`
    writes, in the field order flax writes."""
    def rms(r):
        return {f: _np(getattr(r, f)) for f in RunningMeanStd._fields}

    adam = ts.opt_state
    return {
        "params": flax_network(ts.params),
        "opt_state": {"0": {}, "1": {
            "count": np.asarray(_np(adam.count), np.int32),
            "mu": flax_network(adam.mu), "nu": flax_network(adam.nu)}},
        "obs_rms": rms(ts.obs_rms),
        "value_rms": rms(ts.value_rms),
        "lr": np.asarray(_np(ts.lr), np.float32),
        "epoch": np.asarray(_np(ts.epoch), np.int32),
        "key": np.asarray(ts.key, np.uint32),
    }
