"""The plain reference that decides a run's `correct`.

A frozen copy of the port's plain path at commit d76e677 (the plain engine
`ops/engine.py` with its kinematics, dynamics, contact, sensor and solve
modules, the robot model and its `stl` asset, the kick task with its base
and domain randomization, the MPPI solver and the PPO arithmetic), with the
package prefix rewritten and the CUDA kernel left out: the reference always
steps the plain engine.  It imports nothing of `bez_isaacgym_tpu_torch`,
`bez_isaacgym_tpu` or JAX, and later changes to the port do not reach it.

Unlike the port, it leaves the TF32 flags alone: `portbench.compare` sets
them around every reference run (off for the reference, on for its control).
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device the reference runs on; raises if CUDA is asked for and
    absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but absent")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device
