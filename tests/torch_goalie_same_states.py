"""The goalie eval of the JAX package and of the port from the same states.

    python tests/torch_goalie_same_states.py --seed 0
    python tests/torch_goalie_same_states.py --write

Draws the JAX eval's own initial states (`reset_one` over
`split(PRNGKey(seed), 64)` under `jit`, as `bez_isaacgym_tpu.eval.task_eval`
does), runs the JAX `eval_goalie` from them, then the port's `eval_goalie`
on the CPU from the same states carried across with `convert`, and prints
both results.  The two evals draw their resets from different generators
(`jax.random` against `torch.Generator`), so at one seed they start from
different robots; from the same robots they can be compared env for env.
A full eval takes minutes on the CPU.

`--write` instead writes the states of seeds 0-3 (256 envs, seed by seed),
carried across with `convert`, to STATES: one array per EnvState leaf
("physics.q", "dyn.kp", "progress", ...).  `chip_smoke.py` phase 9 runs the
port's goalie eval from them on the card, against the JAX eval's results
from the same states (this script's output at seeds 0-3).
"""

import argparse
import json
import sys
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
STATES = ROOT / "tests" / "data" / "goalie_jax_reset_states.npz"
SEEDS = range(4)


def jax_reset_states(seed: int, num_envs: int = 64):
    """The JAX goalie eval's initial states at `seed`, as the port's
    EnvState on the CPU."""
    import jax

    from bez_isaacgym_tpu.tasks.goalie import GoalieTask as JGoalieTask
    from bez_isaacgym_tpu_torch import convert

    keys = jax.random.split(jax.random.PRNGKey(seed), num_envs)
    return convert.env_state(jax.tree.map(
        np.asarray, jax.jit(jax.vmap(JGoalieTask().reset_one))(keys)))


def write_states(path: Path = STATES):
    import torch

    states = [jax_reset_states(seed) for seed in SEEDS]
    flat = {}
    for name in states[0]._fields:
        parts = [getattr(s, name) for s in states]
        if hasattr(parts[0], "_fields"):
            for f in parts[0]._fields:
                flat[f"{name}.{f}"] = torch.cat(
                    [getattr(p, f) for p in parts]).numpy()
        else:
            flat[name] = torch.cat(parts).numpy()
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **flat)
    print(f"wrote {path}: {len(flat)} arrays, "
          f"{sum(a.nbytes for a in flat.values())} bytes")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--write", action="store_true",
                    help=f"write the states of seeds 0-3 to {STATES}")
    args = ap.parse_args(argv)
    if args.write:
        write_states()
        return

    from bez_isaacgym_tpu.eval import task_eval as jeval
    from bez_isaacgym_tpu_torch.eval import task_eval as teval
    from bez_isaacgym_tpu_torch.tasks.goalie import GoalieTask

    ckpt = str(ROOT / "runs" / "Bez_Goalie" / "Bez_Goalie_best.ckpt")
    states = jax_reset_states(args.seed)
    ref = jeval.eval_goalie(ckpt, 64, args.steps, args.seed)

    reset = GoalieTask.reset
    first = []

    def from_jax_states(self, gen, n, dr_step=0):
        # The eval's first reset takes the JAX states; the task's own
        # auto-resets (after each env's first episode) draw as usual.
        first.append(n)
        return states if len(first) == 1 else reset(self, gen, n, dr_step)

    with mock.patch.object(GoalieTask, "reset", from_jax_states):
        port = teval.eval_goalie(ckpt, 64, args.steps, args.seed,
                                 device="cpu")
    keys = ("block_rate", "conceded_rate", "fall_rate", "mean_min_ball_x_m")
    print(json.dumps({"seed": args.seed,
                      "jax": {k: ref[k] for k in keys},
                      "port_cpu_same_states": {k: port[k] for k in keys}}))


if __name__ == "__main__":
    main()
