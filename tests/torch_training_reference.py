"""The JAX package's own f32 training and recurrent play, as references for
the port's training checks on the card.

    python tests/torch_training_reference.py finetune [--iterations 20]
    python tests/torch_training_reference.py lstm-play

`finetune` runs the JAX runner as `python train.py task=bez_kick
checkpoint=runs/Bez_Kick/Bez_Kick_best.ckpt train.lr_max=2e-5
num_envs=256 max_iterations=N output_dir=<a temporary directory>` would,
and `lstm-play` as `python play.py task=bez_kick
checkpoint=runs/Bez_Kick_LSTM/Bez_Kick_LSTM_best.ckpt train.rnn_units=128
train.seq_len=4 num_envs=64` would (600 steps, deterministic).  Both on
the CPU in f32.  The runners log only means, so `BezTask.step_batch` is
wrapped to hand every step's (episode return, done) to the host, and the
script prints the completed episodes' returns as count, mean, standard
deviation and standard error, per window of iterations (finetune) or for
the whole play: `chip_smoke.py` phase 11 sets its bars from these.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _stats(returns) -> dict:
    r = np.asarray(returns, np.float64)
    n = len(r)
    sd = float(r.std(ddof=1)) if n > 1 else float("nan")
    return {"episodes": n, "mean": float(r.mean()) if n else float("nan"),
            "sd": sd, "se": sd / np.sqrt(n) if n > 1 else float("nan")}


def _tapped_runner(argv, steps_per_record: int):
    """A JAX Runner for `argv` whose env steps report (ep_reward, done) to
    the host; returns (runner, records) with records[i] the completed
    episodes' returns of block i of `steps_per_record` env steps."""
    import jax

    from bez_isaacgym_tpu.rl.runner import Runner
    from bez_isaacgym_tpu.tasks.base import BezTask
    from bez_isaacgym_tpu.utils.config import parse_overrides

    jax.config.update("jax_compilation_cache_dir", "/tmp/jax_cache")
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    records, steps = [], [0]
    real = BezTask.step_batch

    def take(ep_reward, done):
        if steps[0] % steps_per_record == 0:
            records.append([])
        steps[0] += 1
        records[-1].extend(np.asarray(ep_reward)[np.asarray(done)].tolist())

    def tapped(self, states, actions):
        out = real(self, states, actions)
        jax.debug.callback(take, out.state.ep_reward, out.done, ordered=True)
        return out

    BezTask.step_batch = tapped
    return Runner(parse_overrides(argv)), records


def finetune(iterations: int, num_envs: int) -> dict:
    with tempfile.TemporaryDirectory() as out:
        argv = ["task=bez_kick",
                "checkpoint=runs/Bez_Kick/Bez_Kick_best.ckpt",
                "train.lr_max=2e-5", f"num_envs={num_envs}",
                f"max_iterations={iterations}", f"output_dir={out}",
                "log_frequency=1"]
        runner, records = _tapped_runner(argv, 32)
        runner.train()
        lines = (Path(out) / "Bez_Kick" / "metrics.jsonl").read_text()
    metrics = [json.loads(s) for s in lines.splitlines()]
    windows = {f"iterations 1-{k}": _stats(sum(records[:k], []))
               for k in (5, 10, iterations)}
    return {"command": "python train.py " + " ".join(argv[:-2]),
            "per_iteration": [_stats(r) for r in records],
            "windows": windows,
            "ep_reward_ema": [m["ep_reward_ema"] for m in metrics]}


def lstm_play(num_envs: int, steps: int) -> dict:
    argv = ["test=True", "task=bez_kick",
            "checkpoint=runs/Bez_Kick_LSTM/Bez_Kick_LSTM_best.ckpt",
            "train.rnn_units=128", "train.seq_len=4", f"num_envs={num_envs}"]
    runner, records = _tapped_runner(argv, steps)
    mean_ep = runner.play(num_steps=steps)
    return {"command": "python play.py " + " ".join(argv[1:]),
            "runner_mean_episode_reward": mean_ep,
            "play": _stats(sum(records, []))}


def main(argv=None) -> dict:
    from bez_isaacgym_tpu.utils.backend import force_cpu

    force_cpu()
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=["finetune", "lstm-play"])
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--num-envs", type=int, default=0)
    args = ap.parse_args(argv)
    if args.what == "finetune":
        res = finetune(args.iterations, args.num_envs or 256)
    else:
        res = lstm_play(args.num_envs or 64, 600)
    print(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
