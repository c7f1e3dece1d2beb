"""PyTorch + CUDA port of the Bez simulation and MPC stack.

The JAX package `bez_isaacgym_tpu` is the reference; this package mirrors its
layout (`models/`, `ops/`, `tasks/`, `solvers/`) and imports nothing from it.
The physics substep runs as a hand-written CUDA kernel (`ops/substep.py`,
`csrc/`) on a CUDA device and as plain PyTorch (`ops/engine.py`) on the CPU.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; "cuda" unless the caller asks.

    Raises when CUDA is asked for and absent (no silent CPU fallback), and
    pins full fp32 on the card: no TF32 in matmuls or convolutions.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device
