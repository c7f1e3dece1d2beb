"""Train CLI (port of the repository's `train.py`; reference parity:
bez_isaacgym/train.py).

    python -m bez_isaacgym_tpu_torch.train task=bez_kick num_envs=4096 seed=42
    python -m bez_isaacgym_tpu_torch.train task=bez_kick \\
        checkpoint=runs/Bez_Kick/Bez_Kick_best.ckpt train.lr_max=2e-5
    python -m bez_isaacgym_tpu_torch.train train.rnn_units=128 \\
        train.seq_len=4
    python -m bez_isaacgym_tpu_torch.train task=bez_walk test=True \\
        checkpoint=runs/Bez_Walk/Bez_Walk_best.ckpt

Runs on the CUDA device (the physics through the substep kernel) and
raises without one; `device=cpu` runs a tiny run on the CPU.  With more
than one card, train data-parallel with one process per card (NCCL):

    torchrun --nproc-per-node 4 -m bez_isaacgym_tpu_torch.train \
        task=bez_kick num_envs=16384
"""

import sys

import torch.distributed as dist

from bez_isaacgym_tpu_torch.rl.runner import Runner
from bez_isaacgym_tpu_torch.utils.config import parse_overrides


def main(argv):
    cfg = parse_overrides(argv)
    try:
        runner = Runner(cfg)
        return runner.play() if cfg.test else runner.train()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
