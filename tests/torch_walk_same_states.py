"""The standalone classical walk of the JAX package from its own states.

    python tests/torch_walk_same_states.py
    python tests/torch_walk_same_states.py --write

Draws the JAX eval's own initial states (`reset_one` over
`split(PRNGKey(seed), 64)` under `jit`, as
`bez_isaacgym_tpu.eval.walk_standalone.eval_classical_walk` does at its
defaults: goal_range 0.5, goal_range_min 0.15, 10 s episodes).  The two
packages draw their resets from different generators (`jax.random`
against `torch.Generator`), so at one seed they start from different
robots; from the same robots their evals can be compared env for env.

Without `--write` it runs the JAX `eval_classical_walk` (f32, on the CPU)
at seeds 0 and 1 and prints one JSON line per seed and one for the two
seeds together: the rates from which `chip_smoke.py` phase 13 sets its
bars (3 binomial standard deviations, n = 128).  Each seed takes a few
minutes on the CPU, most of it the host's leg plans.

`--write` instead writes the states of seeds 0 and 1 (128 envs, seed by
seed), carried across with `convert`, to STATES: one array per EnvState
leaf ("physics.q", "dyn.kp", "progress", ...).  Phase 13 runs the port's
eval from them on the card as one eval of 128 envs.
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
STATES = ROOT / "tests" / "data" / "walk_jax_reset_states.npz"
SEEDS = (0, 1)
RATES = ("win_rate", "fall_rate", "stray_rate", "timeout_rate")


def jax_reset_states(seed: int, num_envs: int = 64, goal_range: float = 0.5,
                     goal_range_min: float = 0.15,
                     episode_length_s: float = 10.0):
    """The JAX standalone walk's initial states at `seed` (for the task
    configuration its arguments give), as the port's EnvState on the
    CPU."""
    import jax

    from bez_isaacgym_tpu.tasks.walk import WalkTask, walk_config
    from bez_isaacgym_tpu_torch import convert

    task = WalkTask(dataclasses.replace(
        walk_config(), goal_range=goal_range, goal_range_min=goal_range_min,
        episode_length_s=episode_length_s))
    keys = jax.random.split(jax.random.PRNGKey(seed), num_envs)
    return convert.env_state(jax.tree.map(
        np.asarray, jax.jit(jax.vmap(task.reset_one))(keys)))


def flatten(states) -> dict:
    """EnvStates (seed by seed) -> one array per leaf, envs concatenated."""
    import torch

    flat = {}
    for name in states[0]._fields:
        parts = [getattr(s, name) for s in states]
        if hasattr(parts[0], "_fields"):
            for f in parts[0]._fields:
                flat[f"{name}.{f}"] = torch.cat(
                    [getattr(p, f) for p in parts]).numpy()
        else:
            flat[name] = torch.cat(parts).numpy()
    return flat


def write_states(path: Path = STATES):
    flat = flatten([jax_reset_states(seed) for seed in SEEDS])
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **flat)
    print(f"wrote {path}: {len(flat)} arrays, "
          f"{sum(a.nbytes for a in flat.values())} bytes")


def bars(p: float, n: int) -> tuple:
    """p -/+ 3 binomial standard deviations at n envs."""
    s = 3.0 * float(np.sqrt(p * (1.0 - p) / n))
    return p - s, p + s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--write", action="store_true",
                    help=f"write the states of seeds 0 and 1 to {STATES}")
    args = ap.parse_args(argv)
    if args.write:
        write_states()
        return

    from bez_isaacgym_tpu.eval.walk_standalone import eval_classical_walk

    counts = {k: 0.0 for k in RATES}
    for seed in SEEDS:
        res = eval_classical_walk(num_envs=64, seed=seed)
        print(json.dumps({"seed": seed, **res}), flush=True)
        for k in RATES:
            counts[k] += 64 * res[k]
    n = 64 * len(SEEDS)
    print(json.dumps({"seeds": list(SEEDS), "num_envs": n, **{
        k: {"rate": counts[k] / n, "count": int(round(counts[k])),
            "bars_3sd": bars(counts[k] / n, n)} for k in RATES}}))


if __name__ == "__main__":
    main()
