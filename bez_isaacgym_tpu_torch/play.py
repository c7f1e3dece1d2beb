"""Inference CLI (port of the repository's `play.py`; reference parity:
bez_isaacgym/play.py LaunchModel).

    python -m bez_isaacgym_tpu_torch.play \\
        checkpoint=runs/Bez_Kick/Bez_Kick_best.ckpt task=bez_kick num_envs=16
    python -m bez_isaacgym_tpu_torch.play \\
        checkpoint=runs/Bez_Kick_LSTM/Bez_Kick_LSTM_best.ckpt \\
        train.rnn_units=128 train.seq_len=4 num_envs=64

Runs on the CUDA device and raises without one; `device=cpu` for the CPU.
"""

import sys

from bez_isaacgym_tpu_torch.rl.runner import Runner
from bez_isaacgym_tpu_torch.utils.config import parse_overrides


class LaunchModel:
    """Programmatic API parity with play.py:63-123."""

    def __init__(self, checkpoint: str = "", num_envs: int = 16,
                 task: str = "bez_kick", device: str = "cuda"):
        overrides = [f"task={task}", f"num_envs={num_envs}", "test=True",
                     f"device={device}"]
        if checkpoint:
            overrides.append(f"checkpoint={checkpoint}")
        self.cfg = parse_overrides(overrides)
        self.runner = None

    def load_config(self):
        self.runner = Runner(self.cfg)

    def run_model(self, num_steps: int = 600):
        if self.runner is None:
            self.load_config()
        return self.runner.play(num_steps=num_steps)


def main(argv):
    cfg = parse_overrides(["test=True", "num_envs=16"] + argv)
    return Runner(cfg).play()


if __name__ == "__main__":
    main(sys.argv[1:])
