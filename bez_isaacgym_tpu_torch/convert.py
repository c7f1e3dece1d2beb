"""Carry state and parameters across from the JAX package's pytrees.

Plain numpy-in, torch-out functions: the caller hands over the JAX side's
NamedTuples / RobotModel with their leaves as numpy arrays (for example
`jax.tree.map(np.asarray, state)`), and gets the port's tensors on a given
device.  Fields are matched by name, so fields the port does not carry (the
PRNG `key` of EnvState) are dropped.  Nothing here imports the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bez_isaacgym_tpu_torch.models.robot import DynParams, RobotModel, Site
from bez_isaacgym_tpu_torch.ops.engine import PhysicsState
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
