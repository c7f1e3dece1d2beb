"""The JAX package's own f32 run of the sqp-policy kick eval, the reference
for the port's sqp-policy bars on the card.

    python tests/torch_sqp_reference.py --chunk C [--chunks 4] [--seed 0]
    python tests/torch_sqp_reference.py --combine out_0.json out_1.json ...

Runs the JAX eval as `python -m bez_isaacgym_tpu.eval.kick_eval --solver
sqp-policy --warm-reg 0.5 --num-envs 64 --steps 600` would (substeps 4,
H=32, one Gauss-Newton iteration, the kick policy's rollout as the
nominal), on the CPU in f32, in `--chunks` runs of 64/chunks envs so that
each process stays small: the envs of one eval are independent (each
env's tallies close at its own first done), so chunk C takes the reset
states the 64-env eval draws for its envs C*n .. C*n+n-1 and runs them as
an eval of its own.  Each chunk prints one JSON line; `--combine` adds the
chunks up into the 64-env rates.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

KICK = str(ROOT / "runs" / "Bez_Kick" / "Bez_Kick_best.ckpt")
N_ENVS = 64
RATES = ("success_rate", "kicked_rate", "fall_rate", "mean_ball_progress_m")


def run_chunk(chunk: int, chunks: int, seed: int) -> dict:
    import jax
    import jax.numpy as jnp

    from bez_isaacgym_tpu.eval import kick_eval as jeval
    from bez_isaacgym_tpu.tasks.base import TaskConfig
    from bez_isaacgym_tpu.tasks.kick import KickTask

    jax.config.update("jax_compilation_cache_dir", "/tmp/jax_cache")
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    n = N_ENVS // chunks
    task = KickTask(TaskConfig(substeps=4, use_pallas=False))
    # The reset states of the 64-env eval at this seed.
    all_states = jax.jit(jax.vmap(task.reset_one))(
        jax.random.split(jax.random.PRNGKey(seed), N_ENVS))
    mine = jax.tree.map(lambda a: a[chunk * n:(chunk + 1) * n], all_states)
    chunk_keys = jax.random.split(jax.random.PRNGKey(seed), n)
    real_reset_one = KickTask.reset_one

    def reset_one(self, rkey, dr_step=0):
        # The eval's own reset keys pick this chunk's states; the resets
        # after an env's first episode (which no tally reads) draw as usual.
        hit = jnp.all(rkey == chunk_keys, axis=-1)
        fresh = real_reset_one(self, rkey, dr_step)
        i = jnp.argmax(hit)
        return jax.tree.map(
            lambda a, b: jnp.where(jnp.any(hit), a[i], b), mine, fresh)

    KickTask.reset_one = reset_one
    jeval.TaskConfig = lambda **kw: TaskConfig(use_pallas=False, **kw)
    res = jeval.eval_sqp_policy(num_envs=n, steps=600, seed=seed,
                                horizon=32, iterations=1, substeps=4,
                                warm_reg=0.5, policy_prior=KICK)
    return {"chunk": chunk, "chunks": chunks, "seed": seed, "num_envs": n,
            **{k: res[k] for k in RATES}}


def combine(paths) -> dict:
    rows = [json.loads(Path(p).read_text().strip().splitlines()[-1])
            for p in paths]
    total = sum(r["num_envs"] for r in rows)
    assert total == N_ENVS and len({r["chunk"] for r in rows}) == len(rows)
    out = {"num_envs": total, "seed": rows[0]["seed"]}
    for k in RATES:
        out[k] = sum(r[k] * r["num_envs"] for r in rows) / total
    for k in ("success_rate", "kicked_rate", "fall_rate"):
        p = out[k]
        out[f"{k}_3sd"] = 3.0 * (p * (1.0 - p) / total) ** 0.5
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunk", type=int, default=0)
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--combine", nargs="*")
    args = ap.parse_args(argv)
    if args.combine:
        print(json.dumps(combine(args.combine)))
    else:
        print(json.dumps(run_chunk(args.chunk, args.chunks, args.seed)),
              flush=True)


if __name__ == "__main__":
    main()
