#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, `nvcc` and
PyTorch built for CUDA.  It imports nothing of JAX or of the JAX package.

Phase 0  set-up: the card's name and power limit; builds the CUDA substep
         kernel from csrc/ (nvcc) and prints the build time, the
         compiler's register/stack/spill report, and the launch
         configuration (envs and threads per block, shared bytes per block,
         blocks resident per SM) with the blocks B=8192 and B=2048 give.
Phase 1  kernel vs plain version on the card: one substep and five control
         steps at B = 8192 (= S*K at S=256, K=32) on the full Bez `stl`
         model, all four asset variants at B=512, a ragged B=1000 and
         per-env joint limits, at the bars the JAX package holds its TPU
         kernel to (tests/test_pallas.py).
Phase 2  standing balance on the kernel: 180 control steps from the ready
         pose (mean height within 0.015 of 0.325, base_quat.w > 0.99).
Phase 3  the main path: KickTask(substeps=2) + MPPISolver(H=32, K=32), one
         solve at S=256, then 20 chained closed-loop ticks (solve, then
         step_batch) at S=64, with the launch counter read around the ticks
         and the plain engine disabled; one step_batch through the kernel
         checked against the plain engine on the card.
Phase 4  where a tick's time goes: torch.profiler over 3 ticks at S=64,
         device time by kernel against the wall clock.
Phase 5  the kernel at substeps=4, the trained controllers' configuration:
         kernel vs plain at the MPPI evals' rollout batches B=2560 (64x40)
         and B=6144 (64x96) with the ball against the leg, one control
         step at both and five at B=2560, phase 1's bars; ms per launch.
Phase 6  policy serving: both kick checkpoints read by the port's reader;
         the player on the card against the player on the CPU on 64
         observations; eval_policy (64 envs, 600 steps, substeps=4,
         deterministic) with Bez_Kick_best and with Bez_Kick_DR_best on the
         nominal env, each held to a bar about 3 binomial standard
         deviations (n=64) from its shipped artifact.
Phase 7  MPPI serving, the plain engine forbidden: eval_mppi at
         runs/Bez_Kick/mpc_kick_eval.json's config (policy prior, K=40) and
         at standalone_mpc_eval.json's (keyframe warm start, K=96), 64 envs,
         600-tick cap, substeps=4, H=32, substeps*(H+1) launches per tick,
         each held to its artifact's bar, except the fall rate with the
         prior: the artifact's 0.031 came from a TPU, and the bar is 3
         standard deviations from the JAX package's own f32 run (0.109).
         Then where a prior tick's time goes: the prior's observe and MLP
         at B=2560 (CUDA events), and torch.profiler over 2 ticks.
Phase 8  the kernel in the new tasks' configurations, against its plain
         version at phase 1's bars: the walk scene (no ball, substeps=4)
         at B=64, 2048 and 1, one substep (the ball's rows copied through)
         and five control steps; the goalie's box model, Kd=0, with the
         10 m/s shot at B=64 and 1, one substep at a time over 20 control
         steps from the kernel's own state (a ball meets a box; the bar is
         1e-3 or twice the plain version's own f32 error against f64,
         whichever is larger: the first substep lands the box feet), then the
         20 steps chained on both, the balls that got past the robot the
         same; the kick task at substeps=8 (tracking's) at B=1.  ms per
         launch (a CUDA graph of 20 chained launches for B <= 64, where a
         Python loop is host-bound) and bound_ms for each.
Phase 9  serving the goalie, orient and walk policies through
         eval/task_eval.py (64 envs; at most 1500, 600 and 600 steps;
         substeps=4, the plain engine forbidden), each held to bars about 3
         binomial standard deviations (n=64) from its shipped artifact,
         except the goalie's fall rate: 3 standard deviations from the JAX
         package's own f32 rate over seeds 0-3 (0.195), not the TPU
         artifact's 0.078.  Then the goalie eval from the JAX eval's own
         initial states at seeds 0-3 (256 envs, tests/data/), held to 3
         standard deviations (n=256) from the JAX results from those states.
Phase 10 the classical stack: eval/tracking.py's kick-skill tracking
         (substeps=8) and closed-loop walk tracking (substeps=4) at B=1,
         the plain engine forbidden, held to tests/test_tracking.py's
         bounds; ms per control step.
Phase 11 training (PPO and recurrent PPO through rl/runner.py, the plain
         engine forbidden, every Runner writing to a temporary directory):
         (a) the kernel against its plain version at training's batch
         B=4096, substeps=4, the kick scene with the ball, on nominal
         params and on params the DR sampler draws at Bez_Kick_DR's config
         past the schedules' ramp (full width), from the task's reset
         states and with the ball against the leg: one substep, one and
         five control steps at phase 1's bars, ms per launch and bound_ms;
         (b) 20 iterations fine-tuning runs/Bez_Kick/Bez_Kick_best.ckpt
         (its Adam moments included) at 4096 envs, units (400, 200, 100),
         horizon 32, minibatch 32768, 5 mini-epochs, lr_max 2e-5: rollout
         and update ms per iteration (CUDA events), frames/s, the idle
         share of one profiled iteration, the mean completed-episode
         return against 3 standard errors of the JAX package's f32 run of
         the same fine-tune (tests/torch_training_reference.py), and the
         saved checkpoint restored by PpoPlayerContinuous acting as the
         trainer; (c) 100 iterations from scratch at 4096 envs, seed 42:
         ep_reward_ema must rise by half the JAX record's rise over its
         first 100 iterations; (d) Runner.play of the LSTM checkpoint (64
         envs, 600 steps) against the JAX package's f32 play of it, then 2
         recurrent training iterations at 4096 envs from it.  Launches must
         be substeps x horizon per iteration exactly.
Phase 12 the SQP stage and the hybrid solver: (a) the struct linearization
         (plain engine under torch.func) on the card against the CPU and
         against jacfwd, in contact and airborne, substeps 1 and 4
         (tests/test_solvers.py's bars); the sequential Riccati pass
         against the parallel one at S=64, T=32, n=58, m=18; one SQP solve
         (S=16, H=32, substeps 2) with kernel rollouts against plain ones,
         the same accepted step and cost wherever the plain solve itself is
         stable under a 1e-6 move of its start state; the kernel against
         its plain version at the SQP's batches B=256 (substeps 4), 64 and
         16 (substeps 2), ms per launch and bound_ms; then, the plain
         engine's substep forbidden: (b) bench.py::run_sqp_bench's
         configuration, 5 solves with 1 and with 2 iterations
         (relinearize_every 2), the median and the split into
         linearization, cost gradients, backward pass and line search (CUDA
         events), launches = substeps x H x (1 + iterations) per solve, the
         idle share of one profiled solve, Riccati ms at S=16 and 64;
         (c) eval_sqp_policy at runs/Bez_Kick/sqp_kick_eval.json's config
         (64 envs, 600-tick cap, substeps 4, H=32, warm_reg 0.5), bars about
         3 binomial standard deviations from the artifact, 388 launches per
         tick, peak memory; (d) eval_mppi(use_sqp=True) at phase 3's MPPI
         config, S=16, 20 ticks, every SQP cost at most its MPPI nominal's,
         194 launches per tick.
Phase 13 the standalone classical walk (eval/walk_standalone.py): the kernel
         against its plain version at this path's batch, B=128 (the walk
         scene, substeps 4, from the JAX eval's own seed 0-1 initial
         states, tests/data/), and at B=64, one substep and five control
         steps at phase 1's bars, ms per launch and bound_ms; then
         eval_classical_walk from those states, 128 envs, 10 s episodes,
         the plain engine forbidden, each rate (win, fall, stray, timeout)
         within 3 binomial standard deviations (n=128) of the JAX
         package's f32 run from the same states; ms per control step, the
         host time in the leg plans and the feedforward per leg, the
         eval's wall time, and the idle share of 50 profiled steps; the
         camera model's pixel -> floor -> pixel round trip; the native
         C++ libraries built from native/ with this machine's compiler,
         their C++ unit tests, and compile_urdf_native against the port's
         Python URDF compile on the four asset variants.
Phase 14 data parallelism on the one card (parallel/, viz/,
         utils/profiling.py): (a) 2 ranks spawned with torch.multiprocessing
         (the kernel built in the parent first), both on cuda:0 over gloo,
         train through Runner with multi_chip=True for 3 iterations at PR
         5's width (kick, substeps 4, the ball, units (400, 200, 100),
         horizon 32, 4,096 global envs, 2,048 each), the plain engine
         forbidden: the ranks' parameters and Adam state bit-identical
         after every iteration, 128 launches per rank per iteration, rank
         0 alone writing metrics.jsonl; iteration 1 against the
         single-process update on the concatenated shards (each minibatch
         the union of the ranks'); ms per iteration split into rollout,
         update and all_reduce, frames/s per rank and in total against
         phase 11's; the kernel at B=2048 while the other rank launches
         too; (d) profile_fn over one rollout step (the substep kernel
         among the top kernels) and sol_report; (b) data-parallel MPPI at
         phase 3's configuration, S=64 as 2 x 32, each rank's actions
         against a single-process solve of its slice with its generator;
         (c) the viz geometry from card states against the CPU, and the
         render path without matplotlib raising before the first step
         (with it, a rendered episode).
In phases 6, 7, 9, 10, 11, 12 and 13 the env steps are counted at
BezTask.step_batch, apart from the launch counter, and the launches must be
exactly the substeps (times H+1 for MPPI) of every step; a tracking
drive's steps must be its plan's length.
Timings are CUDA-event times on this card.  Every phase asserts; any
failure exits non-zero.  The last line is the run's result as JSON.
"""

import dataclasses
import json
import math
import operator
import subprocess
import sys
import time
from pathlib import Path

def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of fn, by CUDA events around reps calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(torch, ss, tables, x, p, n_launch: int = 20,
             reps: int = 20) -> float:
    """ms per launch of n_launch chained substep launches captured in one
    CUDA graph and replayed reps times: at small B a Python launch loop
    measures the host, not the kernel."""
    n = ss.state_rows(tables.model.nq)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = x
        for _ in range(3):
            y = ss.substep(tables, y, p)[:n]
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        y = x
        for _ in range(n_launch):
            y = ss.substep(tables, y, p)[:n]
    return cuda_ms(torch, g.replay, reps) / n_launch


OPS = {">=": operator.ge, "<=": operator.le, "==": operator.eq,
       ">": operator.gt, "<": operator.lt}


# Phase 14's settings: PR 5's training width, 2 ranks sharing one card.
P14_RANKS, P14_ENVS, P14_ITERS, P14_SEED = 2, 4096, 3, 42
P14_MPC_S, P14_MPC_SEED = 64, 140


def phase14_rank(rank: int, root: str, out_dir: str) -> dict:
    """One rank of phase 14's harness (spawned by spawn_ranks, which sets
    the environment torchrun would): (a) Runner.train with multi_chip=True
    for P14_ITERS data-parallel PPO iterations on this rank's shard, the
    plain engine forbidden; after each iteration the ranks' parameters and
    Adam state are held bit-identical; iteration 1 runs on permutations
    drawn here and keeps its inputs and output for the parent's
    single-process check; (d) the profile of one rollout step; (b) the
    data-parallel MPPI solve of this rank's slice.  Returns CPU tensors
    and numbers."""
    sys.path.insert(0, root)
    import torch
    import torch.distributed as dist

    from bez_isaacgym_tpu_torch.ops import engine
    from bez_isaacgym_tpu_torch.ops import substep as ss
    from bez_isaacgym_tpu_torch.parallel.mesh import (env_sharding,
                                                      gather_env,
                                                      rank_generator,
                                                      replicated)
    from bez_isaacgym_tpu_torch.parallel.mpc import data_parallel_mpc
    from bez_isaacgym_tpu_torch.rl import ppo as ppo_mod
    from bez_isaacgym_tpu_torch.rl.runner import Runner
    from bez_isaacgym_tpu_torch.solvers.mppi import MPPIConfig, MPPISolver
    from bez_isaacgym_tpu_torch.tasks.base import TaskConfig, tree_map
    from bez_isaacgym_tpu_torch.tasks.kick import KickTask
    from bez_isaacgym_tpu_torch.utils.config import parse_overrides
    from bez_isaacgym_tpu_torch.utils.profiling import (measure_wall,
                                                        profile_fn,
                                                        sol_report)

    def forbidden(*a, **k):
        raise AssertionError("the plain engine ran on the main path")

    engine.substep = forbidden
    runner = Runner(parse_overrides([
        "task=bez_kick", f"num_envs={P14_ENVS}", f"seed={P14_SEED}",
        "multi_chip=True", "log_frequency=1", "save_frequency=100000",
        "save_best_after=100000", f"output_dir={out_dir}"]))
    mesh, dp = runner.mesh, runner.ppo
    assert mesh is not None and mesh.world == P14_RANKS, mesh
    dev = mesh.device
    backend = dist.get_backend(mesh.group)
    ppo = dp.ppo
    cpu = lambda tree: tree_map(  # noqa: E731
        lambda x: x.detach().cpu() if torch.is_tensor(x) else x, tree)

    # Host time inside all_reduce (gloo stages CUDA tensors through the
    # host; the call returns once the reduced buffer is back).
    real_all_reduce = dist.all_reduce
    ar = {"calls": 0, "s": 0.0}

    def timed_all_reduce(*a, **k):
        t0 = time.perf_counter()
        out = real_all_reduce(*a, **k)
        ar["s"] += time.perf_counter() - t0
        ar["calls"] += 1
        return out

    dist.all_reduce = timed_all_reduce
    events = {"rollout": [], "update": [], "iter": []}

    def timed(name, fn):
        def wrapped(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            events[name].append((e0, e1))
            return out
        return wrapped

    kept, rows = {}, []
    real_rollout = ppo.rollout
    real_clip = ppo_mod.clip_by_global_norm

    def clip(grads, max_norm):
        # Iteration 1's gradients, averaged over the ranks, step by step.
        if not rows:
            kept.setdefault("grads", []).append(cpu(grads))
        return real_clip(grads, max_norm)

    ppo_mod.clip_by_global_norm = clip

    def rollout(*a, **k):
        out = real_rollout(*a, **k)
        if "traj" not in kept:
            kept["traj"], kept["last_obs"] = cpu(out[2]), cpu(out[1])
        return out

    ppo.rollout = timed("rollout", rollout)
    ppo.update = timed("update", ppo.update)
    real_iter = timed("iter", dp.train_iter)

    def train_iter(ts, env_state, obs, gen):
        first = not rows
        perms = None
        if first:
            kept["ts0"] = cpu(ts)
            n_local = ppo.cfg.horizon * ppo.num_envs
            perms = [torch.randperm(n_local, generator=gen, device=dev)
                     for _ in range(ppo.cfg.mini_epochs)]
            kept["perms"] = [p.cpu() for p in perms]
        ss.substep.launches = 0
        ar.update(calls=0, s=0.0)
        t0 = time.perf_counter()
        ts, env_state, obs, metrics = real_iter(ts, env_state, obs, gen,
                                                perms=perms)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ss.substep.launches
        replicated(mesh).check((ts.params, ts.opt_state),
                               f"iteration {len(rows) + 1}'s parameters and "
                               f"Adam state")
        if first:
            kept["ts1"] = cpu(ts)
        rows.append({"launches": launches, "allreduce_calls": ar["calls"],
                     "allreduce_host_ms": 1e3 * ar["s"],
                     "wall_ms": 1e3 * wall})
        return ts, env_state, obs, metrics

    dp.train_iter = train_iter
    dist.barrier()
    t_run = time.perf_counter()
    ts = runner.train(P14_ITERS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    dp.train_iter = real_iter
    ms = {k: [e0.elapsed_time(e1) for e0, e1 in v]
          for k, v in events.items()}

    # The gradient buffer's all_reduce alone (124,237 parameters and the
    # KL at units (400, 200, 100)), both ranks at once.
    flat = torch.cat([v.reshape(-1) for v in ts.params.values()] +
                     [torch.zeros(1, device=dev)])
    for _ in range(3):
        real_all_reduce(flat)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(20):
        real_all_reduce(flat)
    torch.cuda.synchronize()
    ar_ms = 1e3 * (time.perf_counter() - t0) / 20
    dist.all_reduce = real_all_reduce

    # The kernel at this rank's B=2048, substeps 4, while the other rank
    # launches it too.
    task = runner.task
    g = torch.Generator(device=dev).manual_seed(1400 + rank)
    env = task.reset(g, P14_ENVS // P14_RANKS)
    tg = task._pre_physics(env, 0.3 * torch.randn(
        (env.physics.q.shape[0], 18), generator=g, device=dev), g)[1]
    tables = task._step_physics_batch.tables
    x = ss.pack_state(env.physics)
    p = ss.pack_params(task.model, env.dyn, tg)
    for _ in range(5):
        ss.substep(tables, x, p)
    torch.cuda.synchronize()
    dist.barrier()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(50):
        ss.substep(tables, x, p)
    e1.record()
    torch.cuda.synchronize()
    kernel_ms = e0.elapsed_time(e1) / 50
    bnd = ss.bound(tables, x)

    # (d) one rollout step of this rank's shard under torch.profiler.
    obs, env = task.observe(env, torch.zeros_like(tg))

    def rollout_step():
        mu, log_std, _ = ppo._apply(ts.params, ts.obs_rms, obs)
        return task.step_batch(env, mu.clamp(-1.0, 1.0), g)

    with torch.no_grad():
        dist.barrier()
        ops = profile_fn(rollout_step, (), iters=3)
        wall_s = measure_wall(rollout_step, (), iters=10)
    subs = task.cfg.control_freq_inv * task.scene.substeps
    report = sol_report(wall_s, subs * bnd.flops, subs * bnd.bytes, ops,
                        top_n=8)
    step_device_ms = sum(o.total_ms for o in ops)
    top = [o.name for o in ops[:10]]
    assert any("bez_substep_kernel" in n for n in top), top

    # (b) data-parallel MPPI at phase 3's configuration, S split over the
    # ranks; every rank resets all S envs from one seed and keeps its rows.
    mtask = KickTask(TaskConfig(substeps=2), device=dev)
    solver = MPPISolver(mtask, MPPIConfig(horizon=32, num_samples=32))
    envs = env_sharding(mesh)(mtask.reset(torch.Generator(
        device=dev).manual_seed(P14_MPC_SEED), P14_MPC_S))
    mpc = data_parallel_mpc(solver, mesh)
    gen_r = rank_generator(P14_MPC_SEED, mesh)
    s_local = P14_MPC_S // mesh.world
    ss.substep.launches = 0
    act, st, info = mpc(envs, solver.init_state(s_local), gen_r)
    torch.cuda.synchronize()
    mpc_launches = ss.substep.launches
    glob = mpc.gather(act)
    assert glob.shape == (P14_MPC_S, 18)
    rows_r = slice(rank * s_local, (rank + 1) * s_local)
    assert torch.equal(glob[rows_r], act)
    gathered_again = gather_env(act, mesh)
    assert torch.equal(gathered_again, glob)
    dist.barrier()
    e0.record()
    n_ticks = 5
    for _ in range(n_ticks):
        a_, st, _ = mpc(envs, st, gen_r)
        envs = mtask.step_batch(envs, a_, gen_r).state
    e1.record()
    torch.cuda.synchronize()
    mpc_ms = e0.elapsed_time(e1) / n_ticks
    dist.barrier()
    return {"rank": rank, "backend": backend, "device": str(dev),
            "run_s": run_s, "rows": rows, "ms": ms, "kept": kept,
            "ts_final": cpu((ts.params, ts.opt_state)),
            "allreduce_ms_grad_buffer": ar_ms, "grad_buffer_floats":
            flat.numel(), "kernel_ms_b2048": kernel_ms,
            "bound_ms_b2048": bnd.ms, "profile": report, "top_ops": top,
            "step_wall_ms": 1e3 * wall_s, "step_device_ms": step_device_ms,
            "mpc_actions": act.cpu(), "mpc_global": glob.cpu(),
            "mpc_launches": mpc_launches, "mpc_ms_per_tick": mpc_ms,
            "env_steps_per_iter": ppo.cfg.horizon}


def phase14_iteration1(kept: list, task) -> dict:
    """Phase 14's iteration 1 against the port's single-process update on
    the concatenated shards: rank r's local sample t * N/2 + e is the
    global t * N + r * N/2 + e, and each minibatch is the union of the
    ranks' minibatches.  `kept` holds each rank's iteration-1 inputs, its
    trajectory, permutations, gradients per step and result; `task` is a
    kick task on the card.  Returns the differences."""
    import torch

    from bez_isaacgym_tpu_torch.rl import ppo as ppo_mod
    from bez_isaacgym_tpu_torch.rl.ppo import PPO, PPOConfig, Transition
    from bez_isaacgym_tpu_torch.tasks.base import tree_map

    dev = task.device
    to_dev = lambda tree: tree_map(  # noqa: E731
        lambda x: x.to(dev) if torch.is_tensor(x) else x, tree)
    for k_ in kept[1:]:
        for a_, b_ in zip(kept[0]["ts0"].params.values(),
                          k_["ts0"].params.values()):
            assert torch.equal(a_, b_)
    n_ranks = len(kept)
    n_local = kept[0]["last_obs"].shape[0]
    n_envs = n_ranks * n_local
    ppo1 = PPO(task, n_envs, PPOConfig())
    ts0 = to_dev(kept[0]["ts0"])
    traj = Transition(*[torch.cat([getattr(k_["traj"], f) for k_ in kept],
                                  dim=1).to(dev)
                        for f in Transition._fields])
    last_obs = torch.cat([k_["last_obs"] for k_ in kept]).to(dev)
    mb_local = ppo1.cfg.minibatch_size // n_ranks
    perms = []
    for e_ in range(ppo1.cfg.mini_epochs):
        parts = []
        for r_, k_ in enumerate(kept):
            loc = k_["perms"][e_].to(dev)
            glob_ = (loc // n_local) * n_envs + r_ * n_local + loc % n_local
            parts.append(glob_[: (loc.numel() // mb_local) * mb_local]
                         .reshape(-1, mb_local))
        perms.append(torch.cat(parts, dim=1).reshape(-1))
    ts1 = ppo1._update_obs_rms(ts0, traj)
    adv_, ret_ = ppo1.compute_gae(ts1, traj, last_obs)
    flat_ = Transition(*[x.reshape((-1,) + x.shape[2:]) for x in traj])
    lrs, grads1 = [], []
    real_adapt, real_clip = ppo_mod.adapt_lr, ppo_mod.clip_by_global_norm

    def tapped_adapt(lr_, kl_, cfg_):
        out_ = real_adapt(lr_, kl_, cfg_)
        lrs.append(float(out_))
        return out_

    def tapped_clip(grads_, max_norm_):
        grads1.append(grads_)
        return real_clip(grads_, max_norm_)

    ppo_mod.adapt_lr, ppo_mod.clip_by_global_norm = tapped_adapt, tapped_clip
    try:
        single, _ = ppo1.update(ts1, flat_, adv_.reshape(-1),
                                ret_.reshape(-1), perms=perms)
    finally:
        ppo_mod.adapt_lr, ppo_mod.clip_by_global_norm = real_adapt, real_clip
    dp1 = to_dev(kept[0]["ts1"])

    def rel(a_, b_):
        return float((a_ - b_).norm() / b_.norm().clamp_min(1e-30))

    cat = lambda d: torch.cat([v.reshape(-1) for v in d.values()])  # noqa
    p_dp, p_1, p_0 = cat(dp1.params), cat(single.params), cat(ts0.params)
    const = single.obs_rms.var < 1e-6
    w0 = "hidden.0.weight"
    d_const = (dp1.params[w0] - single.params[w0])[:, const]
    stats_rel, ratio = {}, 0.0
    for n_ in ("obs_rms", "value_rms"):
        for f_ in ("mean", "var"):
            a_, b_ = getattr(getattr(dp1, n_), f_), getattr(getattr(
                single, n_), f_)
            stats_rel[f"{n_}.{f_}"] = float(((a_ - b_).abs() / b_.abs()
                                             .clamp_min(1e-30)).max())
            ratio = max(ratio, float(((a_ - b_).abs()
                                      / (1e-4 * b_.abs() + 1e-6)).max()))
    return {"grad_steps": [rel(cat(to_dev(g_)), cat(h_)) for g_, h_ in
                           zip(kept[0]["grads"], grads1)],
            "stats_rel": stats_rel, "stats_ratio": ratio,
            "params_rel": rel(p_dp, p_1),
            "update_rel": rel(p_dp - p_0, p_1 - p_0),
            "params_max": float((p_dp - p_1).abs().max()),
            "sum_lr": sum(lrs),
            "mu_rel": rel(cat(dp1.opt_state.mu), cat(single.opt_state.mu)),
            "nu_rel": rel(cat(dp1.opt_state.nu), cat(single.opt_state.nu)),
            "lr": (float(dp1.lr), float(single.lr)),
            "const_obs": int(const.sum()),
            "const_share": float((d_const ** 2).sum()
                                 / ((p_dp - p_1) ** 2).sum())}


def main() -> int:
    import faulthandler

    import torch

    faulthandler.enable()   # a crash in native code prints its Python stack

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "bez_isaacgym_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (the "
              "bez_isaacgym_tpu_torch package is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))

    import numpy as np

    from bez_isaacgym_tpu_torch import resolve_device
    from bez_isaacgym_tpu_torch.models import bez
    from bez_isaacgym_tpu_torch.ops import _build, engine
    from bez_isaacgym_tpu_torch.ops import substep as ss
    from bez_isaacgym_tpu_torch.solvers.mppi import MPPIConfig, MPPISolver
    from bez_isaacgym_tpu_torch.tasks.base import (BezTask, TaskConfig,
                                                   tree_map)
    from bez_isaacgym_tpu_torch.tasks.kick import KickTask

    dev = resolve_device("cuda")
    t_start = time.time()

    # ---------------- phase 0: set-up ---------------------------------------
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.time()
    _build.load()
    log(f"phase0 kernel build s={time.time() - t0:.3f}")
    log(_build.build_log().strip())
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    lc = ss.launch_config(ss.KernelTables(bez.load_bez_model("stl"),
                                          engine.SceneConfig(substeps=2)))
    assert lc.blocks_per_sm >= 1, lc
    log(f"phase0 launch Bez stl: envs_per_block={lc.envs_per_block} "
        f"threads_per_block={lc.threads_per_block} shared_bytes_per_block="
        f"{lc.shared_bytes_per_block} blocks_per_sm={lc.blocks_per_sm} "
        f"(occupancy calculator) SMs={n_sm}; blocks at B=8192: "
        f"{-(-8192 // lc.envs_per_block)}, at B=2048: "
        f"{-(-2048 // lc.envs_per_block)} (resident at once: "
        f"{lc.blocks_per_sm * n_sm})")

    def batch(model, cfg, B, seed, base_z=0.34, kick=False):
        """States around the ready pose (tests/test_pallas.py:28-45).

        kick: the ball against the left leg's boxes, and random joint, base
        and ball velocities (as tests/test_torch_substep_host.py draws them).
        """
        rng = np.random.default_rng(seed)
        q0 = bez.pose_vector(model, bez.READY_JOINT_ANGLES).astype(np.float32)
        q = torch.tensor(q0[None] + rng.uniform(-0.1, 0.1, (B, model.nq)),
                         dtype=torch.float32, device=dev)
        kw = {"ball_pos": (0.1, 0.05, 0.085)} if kick else {}
        st = engine.default_state(model, cfg, q, (0, 0, base_z),
                                  (0, 0, 0, 1), **kw)
        if kick:
            def draw(lo, shape):
                return torch.tensor(rng.uniform(-lo, lo, shape),
                                    dtype=torch.float32, device=dev)
            st = st._replace(qd=draw(0.5, (B, model.nq)),
                             base_u=draw(0.3, (B, 6)),
                             ball_vel=draw(1.0, (B, 3)))
        params = bez.default_dyn_params(model)
        params = params._replace(**{
            k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
            for k, v in params._asdict().items()})
        tg = torch.as_tensor(q0, device=dev).expand(B, model.nq).contiguous()
        return st, params, tg

    def check_steps(model, cfg, st, params, tg, n_steps, label,
                    phase="phase1"):
        """Kernel vs plain step, n_steps control steps, test_pallas bars."""
        kstep = ss.make_kernel_step_fn(model, cfg)
        pstep = engine.make_batched_step_fn(model, cfg)
        a, b = st, st
        for _ in range(n_steps):
            a = kstep(params, a, tg)
            b = pstep(params, b, tg)
        torch.cuda.synchronize()
        errs = {f: float((getattr(a, f) - getattr(b, f)).abs().max())
                for f in ("q", "base_pos", "base_quat", "ball_pos")}
        assert torch.isfinite(a.q).all() and torch.isfinite(a.qd).all(), label
        bars = {"q": 2e-3, "base_pos": 2e-3, "base_quat": 5e-3,
                "ball_pos": 1e-3}
        for f, bar in bars.items():
            assert errs[f] <= bar, (label, f, errs[f], bar)
        # Contact states per sensor slot; per-foot loads (z contact force on
        # each foot body) within 2 N + 30% on >= 99% of feet.
        s_k = a.sensor_normal.cpu().numpy()
        s_p = b.sensor_normal.cpu().numpy()
        agree = (s_k > 0.5) == (s_p > 0.5)
        assert agree.mean() >= 0.99, (label, agree.mean())
        feet = [model.body_index("left_foot"), model.body_index("right_foot")]
        f_k = a.body_contact_force[:, feet, 2].cpu().numpy()
        f_p = b.body_contact_force[:, feet, 2].cpu().numpy()
        ok = np.abs(f_k - f_p) <= 2.0 + 0.3 * np.abs(f_p)
        assert ok.mean() >= 0.99, (label, ok.mean())
        log(f"{phase} {label}: max|kernel-plain| "
            + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
            + f" slot_agree={agree.mean():.4f} feet_ok={ok.mean():.4f}")
        return errs

    # ---------------- phase 1: kernel vs plain ------------------------------
    stl = bez.load_bez_model("stl")
    cfg2 = engine.SceneConfig(substeps=2)
    B_MAIN = 8192
    st, params, tg = batch(stl, cfg2, B_MAIN, seed=0)
    tables = ss.KernelTables(stl, cfg2)
    x = ss.pack_state(st)
    p = ss.pack_params(stl, params, tg)
    out_k = ss.substep(tables, x, p)
    out_p = ss.substep_plain(tables, x, p)
    torch.cuda.synchronize()
    n_state = ss.state_rows(stl.nq)
    max_abs_err = float((out_k[:n_state] - out_p[:n_state]).abs().max())
    assert torch.isfinite(out_k).all()
    assert max_abs_err < 1e-3, max_abs_err
    log(f"phase1 one substep B={B_MAIN}: max|kernel-plain| on the state "
        f"rows = {max_abs_err:.3e}")
    check_steps(stl, cfg2, st, params, tg, 5, f"stl B={B_MAIN} 5 steps")

    # The ball against the left leg, everything moving: the ball-vs-box
    # stage (forces on the robot and on the ball, its spin) is active.
    st_b, params_b, tg_b = batch(stl, cfg2, B_MAIN, seed=4, kick=True)
    xb = ss.pack_state(st_b)
    pb = ss.pack_params(stl, params_b, tg_b)
    act_b = ss.contact_activity(tables, xb)
    out_kb = ss.substep(tables, xb, pb)
    out_pb = ss.substep_plain(tables, xb, pb)
    torch.cuda.synchronize()
    err_b = float((out_kb[:n_state] - out_pb[:n_state]).abs().max())
    assert torch.isfinite(out_kb).all()
    assert err_b < 1e-3, err_b
    # The ball is above the ground, so its velocity change beyond gravity
    # is the boxes' push: nonzero wherever a box touches it.
    bv = slice(2 * stl.nq + 20, 2 * stl.nq + 23)
    dv = out_kb[bv] - xb[bv] - tables.h * params_b.gravity[:, None]
    pushed = int((dv.abs().sum(0) > 1e-4).sum())
    assert act_b.ball_plane == 0 and act_b.box.sum() > 0, act_b
    assert pushed > 0, pushed
    log(f"phase1 ball contact one substep B={B_MAIN}: max|kernel-plain| on "
        f"the state rows = {err_b:.3e}; active ball-box pairs "
        f"{int(act_b.box.sum())}, ball pushed by the boxes in {pushed} envs")
    max_abs_err = max(max_abs_err, err_b)
    check_steps(stl, cfg2, st_b, params_b, tg_b, 5,
                f"stl ball contact B={B_MAIN} 5 steps")
    for variant in ("stl", "box", "box_sensor", "stl_sensor"):
        m = bez.load_bez_model(variant)
        s_, p_, t_ = batch(m, cfg2, 512, seed=1)
        check_steps(m, cfg2, s_, p_, t_, 5, f"{variant} B=512 5 steps")
    s_, p_, t_ = batch(stl, cfg2, 1000, seed=2)
    check_steps(stl, cfg2, s_, p_, t_, 5, "stl ragged B=1000 5 steps")

    # Per-env joint limits (tests/test_pallas.py:148-167).
    s_, p_, _ = batch(stl, cfg2, 256, seed=0)
    hi = p_.dof_upper.expand(256, stl.nq).clone()
    hi[0, 2] = s_.q[0, 2]
    p_ = p_._replace(dof_upper=hi,
                     dof_lower=p_.dof_lower.expand(256, stl.nq).contiguous())
    t_up = torch.as_tensor(stl.dof_upper, dtype=torch.float32,
                           device=dev).expand(256, stl.nq).contiguous()
    kstep = ss.make_kernel_step_fn(stl, cfg2)
    s_lim = s_
    for _ in range(5):
        s_lim = kstep(p_, s_lim, t_up)
    q_lim = s_lim.q.cpu().numpy()
    assert q_lim[0, 2] <= float(hi[0, 2]) + 1e-5, q_lim[0, 2]
    assert q_lim[1, 2] > float(hi[0, 2]) + 1e-3, q_lim[1, 2]
    log(f"phase1 per-env joint limits: env0 q2={q_lim[0, 2]:.5f} <= "
        f"{float(hi[0, 2]):.5f}, env1 q2={q_lim[1, 2]:.5f}")

    # Kernel and plain times at the main path's batch sizes.
    ms_k = cuda_ms(torch, lambda: ss.substep(tables, x, p), reps=50)
    ms_p = cuda_ms(torch, lambda: ss.substep_plain(tables, x, p), reps=5,
                   warmup=1)
    st64, params64, tg64 = batch(stl, cfg2, 64 * 32, seed=3)
    x64 = ss.pack_state(st64)
    p64 = ss.pack_params(stl, params64, tg64)
    ms_k64 = cuda_ms(torch, lambda: ss.substep(tables, x64, p64), reps=50)
    err64 = float((ss.substep(tables, x64, p64)[:n_state]
                   - ss.substep_plain(tables, x64, p64)[:n_state]).abs().max())
    assert err64 < 1e-3, err64
    max_abs_err = max(max_abs_err, err64)
    log(f"phase1 one substep B=2048: max|kernel-plain| on the state rows = "
        f"{err64:.3e}")
    terms = ss.flop_terms(tables, ss.contact_activity(tables, x))
    log("phase1 flops B=" + str(B_MAIN) + " by stage: " + " ".join(
        f"{k}={v}" for k, v in terms.items()))
    b_main = ss.bound(tables, x)
    bound_ms, bound_by = b_main.ms, b_main.by
    log(f"phase1 timing B={B_MAIN}: kernel_ms={ms_k:.5f} plain_ms={ms_p:.3f}"
        f" | B=2048: kernel_ms={ms_k64:.5f}")
    log(f"phase1 bound B={B_MAIN}: bytes={b_main.bytes} "
        f"({b_main.bytes / ss.PEAK_BYTES_PER_S * 1e6:.2f} us at 3.35 TB/s) "
        f"flops={b_main.flops} ({b_main.flops / ss.PEAK_FP32_PER_S * 1e6:.2f}"
        f" us at 67 TFLOP/s fp32) -> bound_ms={bound_ms:.5f} ({bound_by}); "
        f"kernel at {100 * bound_ms / ms_k:.2f}% of bound")

    # ---------------- phase 2: standing balance -----------------------------
    s_, p_, t_ = batch(stl, cfg2, 256, seed=0)
    for _ in range(180):
        s_ = kstep(p_, s_, t_)
    h = s_.base_pos[:, 2].cpu().numpy()
    assert not np.isnan(s_.q.cpu().numpy()).any()
    assert abs(h.mean() - bez.READY_HEIGHT) < 0.015, h.mean()
    assert (s_.base_quat[:, 3].cpu().numpy() > 0.99).all()
    log(f"phase2 standing 180 steps: mean height {h.mean():.4f} "
        f"(ready {bez.READY_HEIGHT}), min quat w "
        f"{float(s_.base_quat[:, 3].min()):.5f}")

    # ---------------- phase 3: the main path --------------------------------
    H, K = 32, 32
    task = KickTask(TaskConfig(substeps=2), device="cuda")
    solver = MPPISolver(task, MPPIConfig(horizon=H, num_samples=K))
    assert hasattr(task._step_physics_batch, "tables"), "kernel not selected"
    gen = torch.Generator(device=dev).manual_seed(0)

    # The step of one tick through the kernel vs the plain engine.
    env = task.reset(gen, 64)
    acts = 0.2 * torch.randn((64, 18), generator=gen, device=dev)
    plain_task = KickTask(TaskConfig(substeps=2, use_kernel=False),
                          device="cuda")
    o_k = task.step_batch(env, acts,
                          torch.Generator(device=dev).manual_seed(1))
    o_p = plain_task.step_batch(env, acts,
                                torch.Generator(device=dev).manual_seed(1))
    err_tick = float((o_k.state.physics.q - o_p.state.physics.q).abs().max())
    err_rew = float((o_k.reward - o_p.reward).abs().max())
    assert err_tick <= 2e-3 and err_rew <= 1e-2, (err_tick, err_rew)
    assert torch.equal(o_k.done, o_p.done)
    log(f"phase3 step_batch kernel vs plain S=64: max|dq|={err_tick:.3e} "
        f"max|dreward|={err_rew:.3e}")

    # No plain physics from here on: the plain substep raises if reached.
    real_substep = engine.substep

    def plain_forbidden(*a, **k):
        raise AssertionError("the plain engine ran on the main path")

    engine.substep = plain_forbidden
    try:
        S_TP = 256
        env = task.reset(gen, S_TP)
        mppi = solver.init_state(S_TP)
        ss.substep.launches = 0
        act, mppi2, info = solver.solve(env, mppi, gen)
        torch.cuda.synchronize()
        assert ss.substep.launches == H * cfg2.substeps, ss.substep.launches
        assert act.shape == (S_TP, 18) and torch.isfinite(act).all()
        assert torch.isfinite(info["best_score"]).all()
        ms_solve = cuda_ms(torch, lambda: solver.solve(env, mppi2, gen),
                           reps=3, warmup=1)
        solves_per_s = S_TP / (ms_solve / 1e3)
        log(f"phase3 throughput S={S_TP} K={K} H={H}: ms_per_solve="
            f"{ms_solve:.2f} solves_per_s={solves_per_s:.1f}")

        S_LAT, N_TICKS = 64, 20
        env = task.reset(gen, S_LAT)
        mppi = solver.init_state(S_LAT)
        torch.cuda.synchronize()
        ss.substep.launches = 0
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t_host = time.time()
        e0.record()
        for _ in range(N_TICKS):
            act, mppi, info = solver.solve(env, mppi, gen)
            out = task.step_batch(env, act, gen)
            env = out.state
        e1.record()
        torch.cuda.synchronize()
        t_host = time.time() - t_host
        launches = ss.substep.launches
        expect = N_TICKS * (H * cfg2.substeps + cfg2.substeps)
        assert launches == expect, (launches, expect)
        assert torch.isfinite(act).all() and act.shape == (S_LAT, 18)
        assert torch.isfinite(info["best_score"]).all()
        assert torch.isfinite(out.reward).all()
        assert torch.isfinite(env.physics.q).all()
        ms_tick = e0.elapsed_time(e1) / N_TICKS
        log(f"phase3 latency S={S_LAT}: {N_TICKS} chained ticks, "
            f"ms_per_tick={ms_tick:.2f} (host clock {1e3 * t_host / N_TICKS:.2f}"
            f"), launches={launches} (expected {expect}), "
            f"mean height {float(env.physics.base_pos[:, 2].mean()):.4f}, "
            f"done {int(out.done.sum())}/{S_LAT}")
    finally:
        engine.substep = real_substep

    # ---------------- phase 4: where a tick's time goes ---------------------
    from torch.profiler import ProfilerActivity, profile

    N_PROF = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_prof = time.time()
        for _ in range(N_PROF):
            act, mppi, info = solver.solve(env, mppi, gen)
            env = task.step_batch(env, act, gen).state
        torch.cuda.synchronize()
        t_prof = time.time() - t_prof
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    total_us = sum(dev_us(e) for e in dev_events)
    wall_ms = 1e3 * t_prof / N_PROF
    if total_us > 0:
        sub_us = sum(dev_us(e) for e in dev_events
                     if "bez_substep_kernel" in e.key)
        n_kern = sum(e.count for e in dev_events) / N_PROF
        dev_ms = total_us / 1e3 / N_PROF
        # Two idle shares: against the profiled wall, which includes the
        # tracing's own cost (an upper bound), and against phase 3's
        # unprofiled tick.
        log(f"phase4 profile S={S_LAT}, {N_PROF} ticks under the profiler: "
            f"wall_ms_per_tick={wall_ms:.2f} device_ms_per_tick="
            f"{dev_ms:.2f} substep_kernel_ms_per_tick="
            f"{sub_us / 1e3 / N_PROF:.2f} other_kernels_ms_per_tick="
            f"{(total_us - sub_us) / 1e3 / N_PROF:.2f} "
            f"kernels_per_tick={n_kern:.0f} idle_share_profiled="
            f"{1 - dev_ms / wall_ms:.3f} idle_share_unprofiled="
            f"{1 - dev_ms / ms_tick:.3f} (phase 3 ms_per_tick="
            f"{ms_tick:.2f})")
        for e in sorted(dev_events, key=dev_us, reverse=True)[:8]:
            log(f"phase4   {dev_us(e) / 1e3 / N_PROF:8.3f} ms/tick "
                f"{e.count / N_PROF:6.0f}x  {e.key[:90]}")
    else:
        log(f"phase4 profile: the profiler reported no device time; "
            f"device split not measured (wall_ms_per_tick={wall_ms:.2f})")

    # ---------------- phase 5: the kernel at substeps=4 ---------------------
    cfg4 = engine.SceneConfig(substeps=4)
    tables4 = ss.KernelTables(stl, cfg4)
    ms_sub4 = {}
    for B_ in (2560, 6144):
        st_, p_, tg_ = batch(stl, cfg4, B_, seed=B_, kick=True)
        x_ = ss.pack_state(st_)
        pp_ = ss.pack_params(stl, p_, tg_)
        act_ = ss.contact_activity(tables4, x_)
        err_ = float((ss.substep(tables4, x_, pp_)[:n_state]
                      - ss.substep_plain(tables4, x_, pp_)[:n_state])
                     .abs().max())
        assert act_.box.sum() > 0, act_
        assert err_ < 1e-3, (B_, err_)
        max_abs_err = max(max_abs_err, err_)
        log(f"phase5 substeps=4 one substep B={B_} ball contact: "
            f"max|kernel-plain| on the state rows = {err_:.3e}; active "
            f"ball-box pairs {int(act_.box.sum())}")
        check_steps(stl, cfg4, st_, p_, tg_, 1,
                    f"substeps=4 ball contact B={B_} 1 step")
        if B_ == 2560:
            check_steps(stl, cfg4, st_, p_, tg_, 5,
                        f"substeps=4 ball contact B={B_} 5 steps")
        ms_sub4[B_] = cuda_ms(torch, lambda: ss.substep(tables4, x_, pp_),
                              reps=50)
        b4 = ss.bound(tables4, x_)
        log(f"phase5 timing substeps=4 B={B_}: kernel_ms={ms_sub4[B_]:.5f}"
            f" bound_ms={b4.ms:.6f} (bytes={b4.bytes} flops={b4.flops}; "
            f"{100 * b4.ms / ms_sub4[B_]:.2f}% of bound)")
    log(f"phase5 card: {card_line()}")

    # ---------------- phases 6 and 7: serving the trained controllers -------
    from bez_isaacgym_tpu_torch.eval import kick_eval
    from bez_isaacgym_tpu_torch.rl.players import (TRAIN_STATE_FIELDS,
                                                   PpoPlayerContinuous)
    from bez_isaacgym_tpu_torch.utils.checkpoint import read_msgpack

    kick_ckpt = root / "runs" / "Bez_Kick" / "Bez_Kick_best.ckpt"
    dr_ckpt = root / "runs" / "Bez_Kick_DR" / "Bez_Kick_DR_best.ckpt"
    launches_by_path = {"mppi_tick_substeps2": launches}
    real_step_batch = BezTask.step_batch
    ms_per_tick = {}        # by eval label
    ticks_by_path = {}      # by eval label
    misses = []             # every eval runs; a missed bar fails at the end

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        return [tree]

    def run_eval(phase, label, fn, per_tick, bars, max_ticks=None,
                 ticks_expected=None, num_envs=64):
        """One eval through its entry point, the launch counter set to 0
        just before and read just after; bars: [(metric, op, bound)].

        The env steps (ticks) are counted apart from the launches, at
        `BezTask.step_batch`, and the launches must be exactly per_tick
        for each: the kernel ran every substep of every tick, and nothing
        else launched it."""
        ticks_run = [0]

        def counted_step_batch(self, *a, **k):
            ticks_run[0] += 1
            return real_step_batch(self, *a, **k)

        BezTask.step_batch = counted_step_batch
        try:
            ss.substep.launches = 0
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.time()
            e0.record()
            res = fn()
            e1.record()
            torch.cuda.synchronize()
            secs = time.time() - t0
            n = ss.substep.launches
        finally:
            BezTask.step_batch = real_step_batch
        ticks = ticks_run[0]
        assert ticks > 0 and n == per_tick * ticks, (label, n, per_tick,
                                                     ticks)
        if max_ticks is not None:
            assert ticks <= max_ticks, (label, ticks, max_ticks)
        if ticks_expected is not None:
            assert ticks == ticks_expected, (label, ticks, ticks_expected)
        ms_tick = e0.elapsed_time(e1) / ticks
        log(f"{phase} {label}: {json.dumps(res)}")
        log(f"{phase} {label}: s={secs:.2f} ticks={ticks} launches={n} "
            f"(= {per_tick} per tick x {ticks} ticks) ms_per_tick="
            f"{ms_tick:.3f} (CUDA events around the whole eval call, set-up "
            f"included) | {card_line()}")
        nums = [v for v in res.values()
                if isinstance(v, (int, float)) and not isinstance(v, bool)]
        assert all(math.isfinite(v) for v in nums), res
        if "num_envs" in res:
            assert res["num_envs"] == num_envs, res
        check_bars(phase, label, res, bars)
        launches_by_path[label] = n
        ms_per_tick[label] = ms_tick
        ticks_by_path[label] = ticks
        return res

    def check_bars(phase, label, res, bars):
        """bars: [(metric, op, bound)]; a miss is kept for the end."""
        for metric, op, bound in bars:
            ok = OPS[op](res[metric], bound)
            log(f"{phase} {label}: {metric}={res[metric]:.6f} {op} {bound}"
                f" {'ok' if ok else 'MISSED'}")
            if not ok:
                misses.append((label, metric, res[metric], op, bound))

    engine.substep = plain_forbidden
    try:
        # ------------ phase 6: policy serving ----------------------------
        for path in (kick_ckpt, dr_ckpt):
            t0 = time.time()
            state = read_msgpack(str(path))
            arrays = leaves(state)
            assert set(state) == set(TRAIN_STATE_FIELDS), sorted(state)
            assert state["params"]["params"]["Dense_0"]["kernel"].shape \
                == (54, 400)
            log(f"phase6 read {path.relative_to(root)}: {len(arrays)} "
                f"arrays, {sum(a.nbytes for a in arrays)} bytes, "
                f"s={time.time() - t0:.3f}")
        task_cpu = KickTask(TaskConfig(substeps=4), device="cpu")
        p_cpu = PpoPlayerContinuous(task_cpu, checkpoint_path=str(kick_ckpt),
                                    device="cpu")
        p_card = PpoPlayerContinuous(task_cpu,
                                     checkpoint_path=str(kick_ckpt),
                                     device="cuda")
        rms = p_cpu.obs_rms
        obs = rms.mean + 2.0 * torch.sqrt(rms.var) * torch.randn(
            (64, 54), generator=torch.Generator().manual_seed(0))
        a_card = p_card.get_action(obs.to(dev))
        err_player = float((a_card.cpu() - p_cpu.get_action(obs))
                           .abs().max())
        assert a_card.device.type == "cuda"
        assert err_player <= 1e-5, err_player
        log(f"phase6 player card vs CPU on 64 observations: max|da| = "
            f"{err_player:.3e}")
        run_eval("phase6", "policy Bez_Kick_best",
                 lambda: kick_eval.eval_policy(str(kick_ckpt), num_envs=64,
                                               steps=600),
                 4, [("success_rate", ">=", 0.90),
                     ("kicked_rate", ">=", 0.95),
                     ("fall_rate", "<=", 0.23)], max_ticks=600)
        run_eval("phase6", "DR policy Bez_Kick_DR_best on the nominal env",
                 lambda: kick_eval.eval_policy(str(dr_ckpt), num_envs=64,
                                               steps=600),
                 4, [("success_rate", ">=", 0.87),
                     ("fall_rate", "<=", 0.18)], max_ticks=600)

        # ------------ phase 7: MPPI serving ------------------------------
        common = dict(num_envs=64, steps=600, horizon=32, temperature=0.05,
                      substeps=4, elite=True, zero_nominal_sample=True)
        prior_cfg = dict(num_samples=40, sigma=0.03, balance_weight=0.6,
                         terminal_balance_weight=10.0, recovery_samples=8,
                         recovery_sigma=0.1, recovery_gate=0.0)
        run_eval("phase7", "MPPI with the policy prior",
                 lambda: kick_eval.eval_mppi(policy_prior=str(kick_ckpt),
                                             **prior_cfg, **common),
                 # The artifact's fall rate, 0.031, was measured on a TPU;
                 # the JAX package in f32 on the CPU, same config and seed,
                 # falls 0.109 (7/64), as the port does: the fall bar is 3
                 # standard deviations from that reference, 0.23.
                 4 * 33, [("success_rate", ">=", 0.93),
                          ("kicked_rate", ">=", 0.95),
                          ("fall_rate", "<=", 0.23)], max_ticks=600)
        run_eval("phase7", "MPPI with the keyframe warm start",
                 lambda: kick_eval.eval_mppi(
                     num_samples=96, sigma=0.08,
                     warm_skill="simulation_rightkick", balance_weight=0.3,
                     terminal_balance_weight=5.0, **common),
                 4 * 33, [("success_rate", ">=", 0.42),
                          ("kicked_rate", ">=", 0.82),
                          ("fall_rate", "<=", 0.08)], max_ticks=600)

        # ------------ phase 7: where a prior tick's time goes -------------
        # The prior runs inside every rollout step: observe + the policy
        # MLP at the rollout batch 64*40, H times per tick.
        task4 = KickTask(TaskConfig(substeps=4), device="cuda")
        player4 = PpoPlayerContinuous(task4, checkpoint_path=str(kick_ckpt))
        solver4 = MPPISolver(
            task4, MPPIConfig(horizon=H, temperature=0.05, elite=True,
                              zero_nominal_sample=True, **prior_cfg),
            prior_fn=lambda o: player4.get_action(o, True))
        g4 = torch.Generator(device=dev).manual_seed(0)
        env4, m4 = task4.reset(g4, 64), solver4.init_state(64)
        flat4 = tree_map(lambda v: v.repeat_interleave(40, dim=0), env4)
        u4 = torch.zeros((64 * 40, 18), device=dev)
        obs4, _ = task4.observe(flat4, u4)
        ms_obs = cuda_ms(torch, lambda: task4.observe(flat4, u4), reps=20)
        ms_mlp = cuda_ms(torch, lambda: player4.get_action(obs4, True),
                         reps=20)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof4:
            t_p4 = time.time()
            for _ in range(2):
                a4, m4, _ = solver4.solve(env4, m4, g4)
                env4 = task4.step_batch(env4, a4, g4).state
            torch.cuda.synchronize()
            t_p4 = (time.time() - t_p4) / 2
        ev4 = [e for e in prof4.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        dev4 = sum(dev_us(e) for e in ev4) / 1e3 / 2
        sub4 = sum(dev_us(e) for e in ev4
                   if "bez_substep_kernel" in e.key) / 1e3 / 2
        n4 = sum(e.count for e in ev4) / 2
        tick4 = ms_per_tick["MPPI with the policy prior"]
        log(f"phase7 prior at B=2560: observe_ms={ms_obs:.3f} "
            f"policy_mlp_ms={ms_mlp:.3f} per rollout step; x{H} per tick = "
            f"{H * (ms_obs + ms_mlp):.2f} ms of the eval's "
            f"{tick4:.2f} ms_per_tick")
        log(f"phase7 profile S=64 K=40 prior, 2 ticks: wall_ms_per_tick="
            f"{1e3 * t_p4:.2f} device_ms_per_tick={dev4:.2f} "
            f"substep_kernel_ms_per_tick={sub4:.2f} kernels_per_tick="
            f"{n4:.0f} idle_share_profiled={1 - dev4 / (1e3 * t_p4):.3f} "
            f"idle_share_vs_eval_tick={1 - dev4 / tick4:.3f} | "
            f"{card_line()}")
    finally:
        engine.substep = real_substep

    # ---------------- phase 8: the kernel in the new configurations ---------
    from bez_isaacgym_tpu_torch.tasks.goalie import GoalieTask
    from bez_isaacgym_tpu_torch.tasks.walk import WalkTask

    b2048 = ss.bound(tables, x64)
    log(f"phase8 bound of phase 1's B=2048 (substeps 2): bound_ms="
        f"{b2048.ms:.6f} ({b2048.by}; bytes={b2048.bytes} flops="
        f"{b2048.flops})")
    ball_rows = slice(2 * stl.nq + 13, n_state)
    p8 = {}                 # config label -> {ms, bound_ms}

    def task_inputs(task, B_, seed, scale):
        """B_ reset states of `task` and the targets of random actions
        through the task's own action pipeline."""
        g = torch.Generator(device=dev).manual_seed(seed)
        env_ = task.reset(g, B_)
        acts_ = scale * torch.randn((B_, 18), generator=g, device=dev)
        return env_, task._pre_physics(env_, acts_, g)[1]

    def time_launch(label, tables_, x_, p_, phase="phase8"):
        B_ = x_.shape[1]
        if B_ <= 128:
            ms_, how = graph_ms(torch, ss, tables_, x_, p_), "CUDA graph"
        else:
            ms_ = cuda_ms(torch, lambda: ss.substep(tables_, x_, p_),
                          reps=50)
            how = "launch loop"
        b = ss.bound(tables_, x_)
        p8[label] = {"ms": ms_, "bound_ms": b.ms}
        log(f"{phase} timing {label}: kernel_ms={ms_:.5f} ({how}) "
            f"bound_ms={b.ms:.4g} ({b.by}; bytes={b.bytes} flops={b.flops}; "
            f"{100 * b.ms / ms_:.2f}% of bound) has_ball="
            f"{tables_.cfg.has_ball} | {card_line()}")

    def load_env_states(path):
        """The EnvState that tests/torch_goalie_same_states.py --write
        saved, one array per leaf, on the card."""
        from bez_isaacgym_tpu_torch.models.robot import DynParams
        from bez_isaacgym_tpu_torch.tasks.base import EnvState

        z = np.load(path)

        def t(key):
            return torch.as_tensor(z[key], device=dev)

        assert EnvState._fields[:2] == ("physics", "dyn")
        return EnvState(
            physics=engine.PhysicsState(**{
                f: t(f"physics.{f}") for f in engine.PhysicsState._fields}),
            dyn=DynParams(**{f: t(f"dyn.{f}") for f in DynParams._fields}),
            **{f: t(f) for f in EnvState._fields[2:]})

    def one_substep(tables_, x_, p_):
        out_k_ = ss.substep(tables_, x_, p_)
        out_p_ = ss.substep_plain(tables_, x_, p_)
        torch.cuda.synchronize()
        assert torch.isfinite(out_k_).all()
        return out_k_, float((out_k_[:n_state] - out_p_[:n_state])
                             .abs().max()), out_p_

    def f32_floor(tables_, x_, p_, out_k_, out_p_):
        """How far the plain version and the kernel, both f32, lie from the
        plain version in f64 on this substep: the precision f32 itself
        gives on this input."""
        out_64 = ss.substep_plain(tables_, x_.double(), p_.double())[:n_state]
        return tuple(float((o[:n_state].double() - out_64).abs().max())
                     for o in (out_p_, out_k_))

    # The walk scene (orient's is the same: stl, no ball, substeps 4).
    walk = WalkTask(device="cuda")
    tables_w = walk._step_physics_batch.tables
    assert not tables_w.cfg.has_ball and tables_w.cfg.substeps == 4
    for B_ in (64, 2048, 1):
        env_, tg_ = task_inputs(walk, B_, 80 + B_, 0.2)
        x_ = ss.pack_state(env_.physics)
        p_ = ss.pack_params(walk.model, env_.dyn, tg_)
        out_k_, err_, out_p_ = one_substep(tables_w, x_, p_)
        assert err_ < 1e-3, (B_, err_)
        # No ball: its rows leave both versions exactly as they came in.
        assert torch.equal(out_k_[ball_rows], x_[ball_rows])
        assert torch.equal(out_p_[ball_rows], x_[ball_rows])
        max_abs_err = max(max_abs_err, err_)
        log(f"phase8 walk no ball one substep B={B_}: max|kernel-plain| on "
            f"the state rows = {err_:.3e}; ball rows unchanged in both")
        check_steps(walk.model, walk.scene, env_.physics, env_.dyn, tg_, 5,
                    f"walk no ball B={B_} 5 steps", phase="phase8")
        time_launch(f"walk_noball_b{B_}", tables_w, x_, p_)

    # The goalie: box model, Kd = 0, the ball shot at 10 m/s from x = 2 m.
    goalie = GoalieTask(device="cuda")
    tables_g = goalie._step_physics_batch.tables
    n_sub = 20 * goalie.cfg.substeps
    env64, tg64 = task_inputs(goalie, 64, 154, 0.1)
    for B_ in (64, 1):
        # B=1: an env of the B=64 batch whose ball meets a box.
        env_, tg_ = (env64, tg64) if B_ == 64 else (
            tree_map(lambda v: v[hit_env:hit_env + 1].clone(), env64),
            tg64[hit_env:hit_env + 1].clone())
        p_ = ss.pack_params(goalie.model, env_.dyn, tg_)
        x_ = ss.pack_state(env_.physics)
        # Each substep's bar is phase 1's 1e-3, or twice the plain
        # version's own f32 error against f64 where that is larger: the
        # goalie starts with its box feet in the ground and Kd = 0, and the
        # first substep's contact impulse leaves velocities near 3.5 rad/s
        # with f32 errors near 1e-3 in the plain version itself.
        err_, hits, most, worst = 0.0, [], (-1, x_), (0.0, 0, 0.0, 0.0)
        for k in range(n_sub):
            act_ = ss.contact_activity(tables_g, x_)
            hits.append(int(act_.box.sum()))
            if hits[-1] > most[0]:
                most = (hits[-1], x_)
            out_k_, e_, out_p_ = one_substep(tables_g, x_, p_)
            floor, k64 = f32_floor(tables_g, x_, p_, out_k_, out_p_)
            assert e_ <= max(1e-3, 2 * floor), (B_, k, e_, floor)
            if e_ > worst[0]:
                worst = (e_, k, floor, k64)
            err_ = max(err_, e_)
            x_ = out_k_[:n_state]
        touched = [k for k, h in enumerate(hits) if h]
        assert touched, "no ball met a box in 20 control steps"
        if B_ == 64:
            hit_env = next(j for j in range(64) if ss.contact_activity(
                tables_g, most[1][:, j:j + 1].contiguous()).box.sum())
        max_abs_err = max(max_abs_err, err_)
        log(f"phase8 goalie shot B={B_}: {n_sub} substeps one at a time "
            f"from the kernel's state, max|kernel-plain| on the state rows "
            f"= {err_:.3e} at substep {worst[1]} (against the plain version "
            f"in f64 there: plain f32 {worst[2]:.3e}, kernel "
            f"{worst[3]:.3e}); ball-box contacts in substeps {touched[0]}-"
            f"{touched[-1]} (control steps {touched[0] // 4}-"
            f"{touched[-1] // 4}), at most {most[0]} active pairs")
        # The 20 steps chained on both: the balls the robot let through
        # (or tunnelled) must be the same envs.
        kst, pst = env_.physics, env_.physics
        kstep_g = ss.make_kernel_step_fn(goalie.model, goalie.scene)
        pstep_g = engine.make_batched_step_fn(goalie.model, goalie.scene)
        for _ in range(20):
            kst = kstep_g(env_.dyn, kst, tg_)
            pst = pstep_g(env_.dyn, pst, tg_)
        passed_k = kst.ball_pos[:, 0] < kst.base_pos[:, 0]
        passed_p = pst.ball_pos[:, 0] < pst.base_pos[:, 0]
        chain = {f: float((getattr(kst, f) - getattr(pst, f)).abs().max())
                 for f in ("q", "base_pos", "ball_pos", "ball_vel")}
        log(f"phase8 goalie shot B={B_} 20 steps chained: max|kernel-plain|"
            f" " + " ".join(f"{k}={v:.3e}" for k, v in chain.items())
            + f"; balls past the robot kernel {int(passed_k.sum())} plain "
            f"{int(passed_p.sum())}; mean ball x kernel "
            f"{float(kst.ball_pos[:, 0].mean()):.4f} plain "
            f"{float(pst.ball_pos[:, 0].mean()):.4f}")
        assert torch.equal(passed_k, passed_p), (passed_k, passed_p)
        time_launch(f"goalie_box_b{B_}", tables_g, most[1], p_)

    # The kick task at substeps = 8 (h = 1/480 s), tracking's configuration.
    kick8 = KickTask(TaskConfig(substeps=8), device="cuda")
    tables_8 = kick8._step_physics_batch.tables
    env_, tg_ = task_inputs(kick8, 1, 88, 0.2)
    x_ = ss.pack_state(env_.physics)
    p_ = ss.pack_params(kick8.model, env_.dyn, tg_)
    _, err_, _ = one_substep(tables_8, x_, p_)
    assert err_ < 1e-3, err_
    max_abs_err = max(max_abs_err, err_)
    log(f"phase8 kick substeps=8 one substep B=1: max|kernel-plain| on the "
        f"state rows = {err_:.3e}")
    check_steps(kick8.model, kick8.scene, env_.physics, env_.dyn, tg_, 5,
                "kick substeps=8 B=1 5 steps", phase="phase8")
    time_launch("kick_substeps8_b1", tables_8, x_, p_)

    engine.substep = plain_forbidden
    try:
        # ------------ phase 9: serving the goalie, orient and walk -------
        from bez_isaacgym_tpu_torch.eval import task_eval

        def ckpt(run):
            return str(root / "runs" / run / f"{run}_best.ckpt")

        # Bars about 3 binomial standard deviations (n=64) from each shipped
        # artifact, on the side that measures quality; the walk artifact
        # documents a policy that fails, so its bars have two sides.
        run_eval("phase9", "goalie policy Bez_Goalie_best",
                 lambda: task_eval.eval_goalie(ckpt("Bez_Goalie"),
                                               num_envs=64, steps=1500),
                 # The artifact's fall rate, 0.078, was measured on a TPU;
                 # the JAX package in f32 on the CPU falls 50/256 = 0.195
                 # over seeds 0-3 (9, 12, 15 and 14 of 64): the fall bar is
                 # 3 standard deviations (n=64) from that rate, 0.34.  The
                 # two packages' generators draw different robots at one
                 # seed; the run below compares them from the same robots.
                 4, [("block_rate", ">=", 0.93), ("fall_rate", "<=", 0.34)],
                 max_ticks=1500)
        # The goalie from the JAX eval's own initial states at seeds 0-3
        # (tests/torch_goalie_same_states.py --write), 256 envs in one eval
        # through the kernel.  From these robots the JAX package in f32
        # blocks 250/256 and falls 50/256; the bars are 3 binomial standard
        # deviations (n=256) from those: 0.948 and 0.269.
        same = load_env_states(
            root / "tests" / "data" / "goalie_jax_reset_states.npz")
        resets = []

        def first_from_jax(self, gen, n, dr_step=0):
            # The eval's first reset takes the JAX states; the auto-resets
            # after each env's first episode draw as usual.
            resets.append(n)
            if len(resets) == 1:
                assert n == same.progress.shape[0], n
                return same
            return BezTask.reset(self, gen, n, dr_step)

        GoalieTask.reset = first_from_jax
        try:
            run_eval("phase9", "goalie from the JAX eval's states, seeds 0-3",
                     lambda: task_eval.eval_goalie(ckpt("Bez_Goalie"),
                                                   num_envs=256, steps=1500),
                     4, [("block_rate", ">=", 0.948),
                         ("fall_rate", "<=", 0.269)],
                     max_ticks=1500, num_envs=256)
        finally:
            del GoalieTask.reset
        assert resets and resets[0] == 256, resets
        run_eval("phase9", "orient policy Bez_Orient_best",
                 lambda: task_eval.eval_orient(ckpt("Bez_Orient"),
                                               num_envs=64, steps=600),
                 4, [("within_0.2rad", ">=", 0.93),
                     ("upright_rate", ">=", 0.93),
                     ("episodes_finished", "==", 64),
                     ("mean_final_angle_err_rad", "<=", 0.2)],
                 max_ticks=600)
        res_w = run_eval("phase9", "walk policy Bez_Walk_best",
                         lambda: task_eval.eval_walk(ckpt("Bez_Walk"),
                                                     num_envs=64, steps=600),
                         4, [("reach_rate_0.25m", ">=", 0.09),
                             ("reach_rate_0.25m", "<=", 0.41),
                             ("fall_rate", ">=", 0.82)], max_ticks=600)
        log(f"phase9 walk policy: win_rate={res_w['win_rate']:.6f} (report "
            f"only; artifact 0.0)")

        # ------------ phase 10: tracking through the classical stack ------
        from bez_isaacgym_tpu_torch.control.controller import \
            SoccerbotController
        from bez_isaacgym_tpu_torch.control.trajectories import Trajectory
        from bez_isaacgym_tpu_torch.control.transformation import \
            Transformation
        from bez_isaacgym_tpu_torch.eval import tracking

        recorded = json.loads((root / "docs" / "TRACKING.json").read_text())
        # Each drive steps once per point of its 60 Hz plan: the kick
        # skill's keyframes, and the walk planner's path to 0.5 m.
        n_kick = len(np.arange(0.0, Trajectory("simulation_rightkick")
                               .max_time, 1 / 60))
        walk_times, _ = SoccerbotController().plan_joint_trajectory(
            Transformation.from_xy_theta(0.5 * tracking.STRIDE_GAIN, 0.0,
                                         0.0))
        n_walk = len(np.arange(0, walk_times[-1], 1 / 60))
        for label, fn, substeps, n_plan, bars in (
                ("kick skill tracking", tracking.kick_skill_tracking, 8,
                 n_kick, [("kick_rel_tracking_err", "<", 0.02),
                          ("kick_joint_rms_rad", "<", 0.02)]),
                ("walk tracking", tracking.walk_tracking, 4, n_walk,
                 [("walk_position_err_frac", "<", 0.02),
                  ("walk_final_x_m", ">", 0.45),
                  ("walk_final_height_m", ">", 0.30),
                  ("walk_final_height_m", "<", 0.36),
                  ("walk_rel_tracking_err", "<", 0.115)])):
            res = run_eval("phase10", label, fn, substeps, bars,
                           ticks_expected=n_plan)
            log(f"phase10 {label}: recorded reference values (docs/"
                f"TRACKING.json, not targets): " + " ".join(
                    f"{k}={recorded[k]:.6f}" for k in res
                    if isinstance(recorded.get(k), float)))
    finally:
        engine.substep = real_substep

    # ---------------- phase 11: training on the card ------------------------
    import tempfile

    from bez_isaacgym_tpu_torch.rl.runner import Runner
    from bez_isaacgym_tpu_torch.tasks.dr import DomainRandConfig
    from bez_isaacgym_tpu_torch.utils.config import parse_overrides

    B_TR, HORIZON = 4096, 32
    # 11a: the kernel at training's batch, on nominal params and on params
    # the port's DR sampler draws at Bez_Kick_DR's config with dr_step past
    # every linear schedule's ramp (schedule_steps 3000): full width.
    dr_cfg = DomainRandConfig(enabled=True)
    dr_full = max(getattr(dr_cfg, f.name).schedule_steps
                  for f in dataclasses.fields(dr_cfg)
                  if hasattr(getattr(dr_cfg, f.name), "schedule_steps"))
    kick_tr = {"nominal": KickTask(TaskConfig(substeps=4), device="cuda"),
               "dr": KickTask(TaskConfig(substeps=4, dr=dr_cfg),
                              device="cuda")}
    tables_tr = kick_tr["nominal"]._step_physics_batch.tables
    p11 = {}
    for label, task_ in kick_tr.items():
        g = torch.Generator(device=dev).manual_seed(110)
        env_ = task_.reset(g, B_TR, dr_step=dr_full if label == "dr" else 0)
        dyn = env_.dyn
        if label == "dr":
            mass_, kp_ = dyn.mass_scale, dyn.kp / task_.base_params.kp
            log(f"phase11 DR params B={B_TR} at dr_step={dr_full}: "
                f"mass_scale [{float(mass_.min()):.3f}, "
                f"{float(mass_.max()):.3f}]"
                f" kp scale [{float(kp_.min()):.3f}, {float(kp_.max()):.3f}]"
                f" friction [{float(dyn.ground_friction.min()):.3f}, "
                f"{float(dyn.ground_friction.max()):.3f}] gravity z "
                f"[{float(dyn.gravity[:, 2].min()):.3f}, "
                f"{float(dyn.gravity[:, 2].max()):.3f}]")
            assert float(mass_.min()) < 0.55 and float(mass_.max()) > 1.45
            assert float(kp_.min()) < 0.55 and float(kp_.max()) > 1.45
        acts_ = 0.3 * torch.randn((B_TR, 18), generator=g, device=dev)
        tg_ = task_._pre_physics(env_, acts_, g)[1]
        # The task's reset states (the training's start), and phase 1's
        # ball against the leg with everything moving, on these params.
        st_leg, _, _ = batch(stl, task_.scene, B_TR, seed=111, kick=True)
        for states, what in ((env_.physics, "reset states"),
                             (st_leg, "ball against the leg")):
            x_ = ss.pack_state(states)
            p_ = ss.pack_params(stl, dyn, tg_)
            act_ = ss.contact_activity(tables_tr, x_)
            _, err_, _ = one_substep(tables_tr, x_, p_)
            assert err_ < 1e-3, (label, what, err_)
            max_abs_err = max(max_abs_err, err_)
            log(f"phase11 {label} params, {what}, B={B_TR} substeps=4 one "
                f"substep: max|kernel-plain| on the state rows = "
                f"{err_:.3e}; active ball-box pairs {int(act_.box.sum())}, "
                f"ball-ground {int(act_.ball_plane)}")
            for n_ in (1, 5):
                check_steps(stl, task_.scene, states, dyn, tg_, n_,
                            f"{label} params {what} B={B_TR} {n_} steps",
                            phase="phase11")
            if what == "reset states":
                ms_tr = cuda_ms(torch,
                                lambda: ss.substep(tables_tr, x_, p_),
                                reps=50)
                b_ = ss.bound(tables_tr, x_)
                p11[label] = {"ms": ms_tr, "bound_ms": b_.ms}
                log(f"phase11 timing {label} params B={B_TR} substeps=4: "
                    f"kernel_ms={ms_tr:.5f} bound_ms={b_.ms:.6f} ({b_.by}; "
                    f"bytes={b_.bytes} flops={b_.flops}; "
                    f"{100 * b_.ms / ms_tr:.2f}% of bound) | {card_line()}")

    def train_run(label, argv, iterations, profile_iter=None):
        """Runner.train through its entry point, the plain engine
        forbidden, the launch counter set to 0 just before and read just
        after; CUDA events around each iteration's rollout, update and
        whole train_iter; torch.profiler over iteration profile_iter."""
        runner = Runner(parse_overrides(argv))
        assert hasattr(runner.task._step_physics_batch, "tables"), label
        ppo = runner.ppo
        events = {"rollout": [], "update": [], "iter": []}
        prof_box = {}

        def timed(name, fn):
            def wrapped(*a, **k):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **k)
                e1.record()
                events[name].append((e0, e1))
                return out
            return wrapped

        ppo.rollout = timed("rollout", ppo.rollout)
        ppo.update = timed("update", ppo.update)
        timed_iter = timed("iter", ppo.train_iter)

        def train_iter(*a, **k):
            if len(events["iter"]) + 1 != profile_iter:
                return timed_iter(*a, **k)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t_p = time.time()
                out = timed_iter(*a, **k)
                torch.cuda.synchronize()
                prof_box.update(wall_ms=1e3 * (time.time() - t_p))
            prof_box["prof"] = prof
            return out

        ppo.train_iter = train_iter
        steps_run = [0]

        def counted_step_batch(self, *a, **k):
            steps_run[0] += 1
            return real_step_batch(self, *a, **k)

        BezTask.step_batch = counted_step_batch
        try:
            ss.substep.launches = 0
            t0 = time.time()
            ts = runner.train(iterations)
            torch.cuda.synchronize()
            secs = time.time() - t0
            n = ss.substep.launches
        finally:
            BezTask.step_batch = real_step_batch
        per_iter = 4 * HORIZON
        assert steps_run[0] == HORIZON * iterations, (label, steps_run)
        assert n == per_iter * iterations, (label, n, per_iter, iterations)
        rows = [json.loads(line) for line in
                (Path(runner.run_dir) / "metrics.jsonl").read_text()
                .splitlines()]
        assert [r["iter"] for r in rows] == list(range(1, iterations + 1))
        assert all(math.isfinite(v) for r in rows for v in r.values()), label
        ms = {k: [e0.elapsed_time(e1) for e0, e1 in v]
              for k, v in events.items()}
        # Steady iterations: after the first, without the profiled one.
        keep = [i for i in range(1, iterations) if i + 1 != profile_iter] \
            or list(range(iterations))
        mean = {k: sum(v[i] for i in keep) / len(keep) for k, v in ms.items()}
        fps = B_TR * HORIZON / (mean["iter"] / 1e3)
        log(f"phase11 {label}: {iterations} iterations in s={secs:.2f}, "
            f"launches={n} (= {per_iter} per iteration x {iterations}), env "
            f"steps {steps_run[0]}; steady iteration ms={mean['iter']:.2f} "
            f"(min {min(ms['iter'][i] for i in keep):.2f}, max "
            f"{max(ms['iter'][i] for i in keep):.2f}) rollout_ms="
            f"{mean['rollout']:.2f} update_ms={mean['update']:.2f} "
            f"frames_per_s={fps:.0f}; first iteration ms={ms['iter'][0]:.2f}"
            f" | {card_line()}")
        out = {"ts": ts, "runner": runner, "rows": rows, "launches": n,
               "ms": mean, "fps": fps}
        if "prof" in prof_box:
            ev = [e for e in prof_box["prof"].key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
            dev_ms = sum(dev_us(e) for e in ev) / 1e3
            sub_ms = sum(dev_us(e) for e in ev
                         if "bez_substep_kernel" in e.key) / 1e3
            wall = prof_box["wall_ms"]
            out.update(device_ms=dev_ms, idle_profiled=1 - dev_ms / wall,
                       idle=1 - dev_ms / mean["iter"])
            log(f"phase11 {label} profile of iteration {profile_iter}: "
                f"wall_ms={wall:.2f} device_ms={dev_ms:.2f} "
                f"substep_kernel_ms={sub_ms:.2f} other_kernels_ms="
                f"{dev_ms - sub_ms:.2f} kernels={sum(e.count for e in ev)} "
                f"idle_share_profiled={1 - dev_ms / wall:.3f} "
                f"idle_share_unprofiled={1 - dev_ms / mean['iter']:.3f}")
            for e in sorted(ev, key=dev_us, reverse=True)[:6]:
                log(f"phase11   {dev_us(e) / 1e3:8.3f} ms {e.count:6d}x  "
                    f"{e.key[:90]}")
        return out

    lstm_ckpt = root / "runs" / "Bez_Kick_LSTM" / "Bez_Kick_LSTM_best.ckpt"
    lstm_over = ["train.rnn_units=128", "train.seq_len=4"]
    engine.substep = plain_forbidden
    try:
        with tempfile.TemporaryDirectory() as tmp:
            runs = Path(tmp)
            # 11b: fine-tuning the shipped kick TrainState, Adam moments
            # included, at full width (lr_max 2e-5: ppo.py's advice for a
            # restored checkpoint).
            start = read_msgpack(str(kick_ckpt))
            ft = train_run("fine-tune Bez_Kick_best", [
                "task=bez_kick", f"checkpoint={kick_ckpt}",
                "train.lr_max=2e-5", f"num_envs={B_TR}", "log_frequency=1",
                "save_frequency=20", "save_best_after=100000",
                f"output_dir={runs / 'finetune'}"], 20, profile_iter=20)
            ts = ft["ts"]
            steps_ft = 20 * 4 * 5          # 4 minibatches x 5 mini-epochs
            assert int(ts.opt_state.count) == \
                int(start["opt_state"]["1"]["count"]) + steps_ft
            assert int(ts.epoch) == int(start["epoch"]) + 20
            done = sum(r["ep_count"] for r in ft["rows"])
            pooled = sum(r["ep_reward_mean"] * r["ep_count"]
                         for r in ft["rows"]) / done
            res_ft = {"episodes": done, "mean_episode_return": pooled,
                      "ep_reward_ema_20": ft["rows"][-1]["ep_reward_ema"]}
            log(f"phase11 fine-tune: {json.dumps(res_ft)}")
            # The JAX package's f32 run of the same fine-tune on the CPU
            # (tests/torch_training_reference.py finetune: 256 envs, 20
            # iterations) completed 2,224 episodes of mean return 22.0618,
            # standard error 0.9024: the bar is 3 standard errors.
            check_bars("phase11", "fine-tune Bez_Kick_best", res_ft,
                       [("mean_episode_return", ">=", 19.355),
                        ("mean_episode_return", "<=", 24.769)])
            saved = next(Path(ft["runner"].run_dir).glob(
                "Bez_Kick_20_rew_*.ckpt"))
            player = PpoPlayerContinuous(ft["runner"].task,
                                         checkpoint_path=str(saved))
            rms = ts.obs_rms
            obs = rms.mean + 2.0 * torch.sqrt(rms.var) * torch.randn(
                (64, 54), generator=torch.Generator(device=dev).manual_seed(0),
                device=dev)
            err_save = float((player.get_action(obs)
                              - ft["runner"].ppo.act(ts, obs)).abs().max())
            assert err_save <= 1e-6, err_save
            log(f"phase11 {saved.name} restored by PpoPlayerContinuous: "
                f"max|player - trainer act| on 64 observations = "
                f"{err_save:.3e}")

            # 11c: learning from scratch at full width, seed 42.
            sc = train_run("from scratch", [
                "task=bez_kick", f"num_envs={B_TR}", "seed=42",
                "log_frequency=1", "save_frequency=100000",
                "save_best_after=100000", f"output_dir={runs / 'scratch'}"],
                100)
            ema = [r["ep_reward_ema"] for r in sc["rows"]]
            res_sc = {"ep_reward_ema_1": ema[0], "ep_reward_ema_100": ema[-1],
                      "rise": ema[-1] - ema[0]}
            log(f"phase11 from scratch: {json.dumps(res_sc)}; ep_reward_ema "
                f"every 10 iterations: "
                + " ".join(f"{v:.3f}" for v in ema[9::10]))
            # Half the rise of the JAX package's recorded start,
            # runs/Bez_Kick_LSTM/metrics.jsonl iterations 1 -> 100 (-1.23 ->
            # 0.65, on a TPU): a rise, not the TPU's value.
            check_bars("phase11", "from scratch", res_sc,
                       [("rise", ">=", 0.94)])

            # 11d: the recurrent checkpoint served by Runner.play, then two
            # recurrent training iterations from it.
            play = Runner(parse_overrides([
                "task=bez_kick", "test=True", f"checkpoint={lstm_ckpt}",
                "num_envs=64", f"output_dir={runs / 'lstm_play'}",
                *lstm_over]))
            def lstm_play():
                play.play(600)
                return play.played

            res_lstm = run_eval("phase11", "LSTM play Bez_Kick_LSTM_best",
                                lstm_play, 4, [], ticks_expected=600)
            # The JAX package's f32 Runner.play of this checkpoint on the
            # CPU (tests/torch_training_reference.py lstm-play): 1,078
            # episodes, mean reward 1.24345 (sd 0.2251); the port's draw is
            # independent, so the bars are 3 standard errors of the
            # difference of two such runs: the mean within 3 x sqrt(2) x
            # 0.006857 = 0.0291, the count within 3 x sqrt(2 x 1078) = 139
            # (Poisson).  The TPU artifact: 1,080 and 1.25.
            check_bars("phase11", "LSTM play", res_lstm,
                       [("mean_episode_reward", ">=", 1.2144),
                        ("mean_episode_reward", "<=", 1.2725),
                        ("episodes", ">=", 939), ("episodes", "<=", 1217)])
            rnn = train_run("recurrent from Bez_Kick_LSTM_best", [
                "task=bez_kick", f"checkpoint={lstm_ckpt}",
                f"num_envs={B_TR}", "log_frequency=1",
                "save_frequency=100000", "save_best_after=100000",
                f"output_dir={runs / 'lstm_train'}", *lstm_over], 2)
            log(f"phase11 recurrent iterations: " + " | ".join(
                f"iter {r['iter']}: loss {r['loss']:.4f} kl {r['kl']:.4f} "
                f"lr {r['lr']:.3e} ep_reward {r['ep_reward_mean']:.3f}"
                for r in rnn["rows"]))
    finally:
        engine.substep = real_substep
    for key, run_ in (("ppo_finetune_20_iterations", ft),
                      ("ppo_from_scratch_100_iterations", sc),
                      ("ppo_rnn_2_iterations", rnn)):
        launches_by_path[key] = run_["launches"]
    log(f"phase11 card: {card_line()}")

    # ---------------- phase 12: the SQP stage and the hybrid solver ---------
    from bez_isaacgym_tpu_torch.solvers import sqp as sqp_mod
    from bez_isaacgym_tpu_torch.solvers.hybrid import HybridSolver
    from bez_isaacgym_tpu_torch.solvers.riccati import (parallel_backward,
                                                        sequential_backward)
    from bez_isaacgym_tpu_torch.solvers.sqp import (SQPConfig, SQPSolver,
                                                    SQPState)

    t12 = time.time()

    def close(a, b, atol, rtol, what):
        err = float((a - b).abs().max())
        rel = float(((a - b).abs() - atol - rtol * b.abs()).max())
        assert torch.isfinite(a).all() and rel <= 0.0, (what, err)
        return err

    # 12a: the struct linearization on the card against the CPU and against
    # jacfwd on the card, from a kick reset state (in contact) and
    # tests/test_solvers.py's airborne state; test_solvers.py's bars.
    u_lin = 0.05 * torch.sin(torch.arange(18.0))
    for sub in (1, 4):
        t_c = KickTask(TaskConfig(substeps=sub), device="cuda")
        t_p = KickTask(TaskConfig(substeps=sub), device="cpu")
        e_c = t_c.reset(torch.Generator(device=dev).manual_seed(120), 1)
        air = e_c.physics._replace(
            base_pos=e_c.physics.base_pos * torch.tensor([1.0, 1.0, 0.0],
                                                         device=dev)
            + torch.tensor([0.0, 0.0, 0.6], device=dev),
            q=t_c.default_dof_pos[None].clone(),
            qd=torch.full((1, 18), 0.4, device=dev),
            ball_pos=torch.tensor([[5.0, 0.0, 0.5]], device=dev))
        rows = tree_map(lambda v: torch.cat([v, v]), e_c)._replace(
            physics=engine.PhysicsState(*[torch.cat([a, b]) for a, b in
                                          zip(e_c.physics, air)]))
        rows_p = tree_map(lambda v: v.cpu(), rows)
        x_c = sqp_mod.flatten_physics(rows.physics)
        u2 = u_lin.expand(2, 18)
        A_s, B_s = SQPSolver(t_c, SQPConfig()).linearize_dynamics(
            rows, x_c, u2.to(dev))
        A_p, B_p = SQPSolver(t_p, SQPConfig()).linearize_dynamics(
            rows_p, x_c.cpu(), u2)
        A_j, B_j = SQPSolver(t_c, SQPConfig(linearize="jacfwd")) \
            .linearize_dynamics(rows, x_c, u2.to(dev))
        e_cpu = max(close(A_s.cpu(), A_p, 1e-4, 1e-3, "A card vs cpu"),
                    close(B_s.cpu(), B_p, 1e-4, 1e-3, "B card vs cpu"))
        e_jac = max(close(A_s, A_j, 1e-4, 1e-3, "A struct vs jacfwd"),
                    close(B_s, B_j, 1e-4, 1e-3, "B struct vs jacfwd"))
        log(f"phase12 struct linearization substeps={sub} (in contact, "
            f"airborne): max|card-cpu|={e_cpu:.3e} max|struct-jacfwd| on "
            f"the card={e_jac:.3e} (largest entry "
            f"{float(A_s.abs().max()):.3g};"
            f" bars atol 1e-4 rtol 1e-3)")

    # Riccati: the sequential pass against the parallel one at S=64, T=32,
    # n=58, m=18 on a random contractive LQ problem (tests/test_riccati.py's
    # construction and bars).
    def lq_problem(S_, seed):
        rng = np.random.default_rng(seed)
        q_, r_ = np.linalg.qr(rng.normal(size=(S_, 32, 58, 58)))
        A_ = 0.9 * q_ * np.sign(np.diagonal(r_, axis1=-2,
                                            axis2=-1))[..., None, :]
        args = (A_, rng.normal(size=(S_, 32, 58, 18)) / np.sqrt(58),
                rng.normal(size=(S_, 32, 58)), rng.normal(size=(S_, 32, 18)))
        return [torch.tensor(a, dtype=torch.float32, device=dev)
                for a in args]

    ric_ms = {}
    for S_ in (16, 64):
        lq = lq_problem(S_, S_)
        g_s = sequential_backward(*lq, 1e-2)
        g_p = parallel_backward(*lq, 1e-2)
        if S_ == 64:
            err_K = close(g_p.K, g_s.K, 2e-4, 2e-3, "riccati K")
            err_k = close(g_p.k, g_s.k, 2e-4, 2e-3, "riccati k")
        for name, fn in (("sequential", sequential_backward),
                         ("parallel", parallel_backward)):
            ric_ms[f"{name}_s{S_}"] = cuda_ms(torch, lambda: fn(*lq, 1e-2),
                                              reps=5, warmup=1)
    log(f"phase12 riccati S=64 T=32 n=58 m=18: max|parallel-sequential| "
        f"K={err_K:.3e} k={err_k:.3e} (bars atol 2e-4 rtol 2e-3); ms "
        + " ".join(f"{k}={v:.2f}" for k, v in ric_ms.items())
        + f" | {card_line()}")

    # One SQP solve at run_sqp_bench's configuration (S=16, H=32, substeps
    # 2, a zero nominal, reset states) with kernel rollouts, against the
    # same solve with the plain engine on the card.  Once the ball rests on
    # the ground the Jacobians reach 1e10 and more (the rolling-friction
    # slope), and the line search's feedback gains multiply any 1e-7
    # difference between two f32 rollouts (the kernel's and the plain
    # engine's summation orders differ) until the accepted step can flip.
    # So the plain solve is also run from its start state moved by 1e-6
    # relative in q and qd, twice: a solve is stable where all three plain
    # solves accept the same step with costs within 1e-4 relative.  On every
    # stable solve the kernel's must accept the same step with its cost
    # within 1e-4 relative.
    S_B, H_B = 16, 32
    kick2 = KickTask(TaskConfig(substeps=2), device="cuda")
    kick2_plain = KickTask(TaskConfig(substeps=2, use_kernel=False),
                           device="cuda")
    env_b = kick2.reset(torch.Generator(device=dev).manual_seed(42), S_B)
    zero_b = SQPState(nominal=torch.zeros((S_B, H_B, 18), device=dev))

    def perturbed(seed):
        g_ = torch.Generator(device=dev).manual_seed(seed)
        return env_b._replace(physics=env_b.physics._replace(**{
            f: getattr(env_b.physics, f) * (1.0 + 1e-6 * torch.randn(
                getattr(env_b.physics, f).shape, generator=g_, device=dev))
            for f in ("q", "qd")}))

    outs = [SQPSolver(t_, SQPConfig(horizon=H_B, iterations=1))
            .solve(e_, zero_b)[2] for t_, e_ in (
                (kick2, env_b), (kick2_plain, env_b),
                (kick2_plain, perturbed(43)), (kick2_plain, perturbed(44)),
                (kick2, env_b))]
    # The solve is repeatable on the card: the same inputs, the same bits.
    assert torch.equal(outs[4]["cost"], outs[0]["cost"]) and torch.equal(
        outs[4]["accepted"], outs[0]["accepted"]), (outs[0], outs[4])
    acc = [o["accepted"] for o in outs]
    cost = [o["cost"] for o in outs]

    def rel(a, b):
        return (a - b).abs() / b.abs().clamp_min(1e-6)

    stable = (acc[1] == acc[2]) & (acc[1] == acc[3]) \
        & (rel(cost[2], cost[1]) <= 1e-4) & (rel(cost[3], cost[1]) <= 1e-4)
    same = (acc[0] == acc[1]) & (rel(cost[0], cost[1]) <= 1e-4)
    assert bool(same[stable].all()), (acc, cost, stable)
    n_acc = int((stable & (acc[1] >= 0)).sum())
    spread = torch.maximum(rel(cost[2], cost[1]), rel(cost[3], cost[1]))
    if (~stable).any():
        log(f"phase12 SQP solve, the {int((~stable).sum())} unstable solves "
            f"(the plain solve's own spread under the 1e-6 move up to "
            f"{float(spread[~stable].max()):.3e} relative in cost): kernel "
            f"vs plain up to {float(rel(cost[0], cost[1])[~stable].max()):.3e}"
            f", the same step in {int((acc[0] == acc[1])[~stable].sum())}")
    log(f"phase12 SQP solve S={S_B} H={H_B} substeps 2, kernel vs plain "
        f"rollouts on the card: accepted steps kernel {acc[0].tolist()}, "
        f"plain {acc[1].tolist()} (-1 = none improved); stable solves "
        f"{int(stable.sum())} of {S_B} ({n_acc} of them with an accepted "
        f"step), all with the same step and max relative cost difference "
        f"{float(rel(cost[0], cost[1])[stable].max()):.3e} (bar 1e-4); the "
        f"kernel's step is the plain one in {int(same.sum())} of {S_B}; "
        f"a second kernel solve bit-equal to the first")
    # The kernel at the SQP's new batches against its plain version: the
    # line search's B = 4S (S=64 at substeps 4, S=16 at substeps 2) and the
    # bench's nominal rollout, B=16 at substeps 2.
    p12 = {}
    for label, task_, B_ in (("sqp_linesearch_b256_substeps4",
                              KickTask(TaskConfig(substeps=4),
                                       device="cuda"), 256),
                             ("sqp_linesearch_b64_substeps2", kick2, 64),
                             ("sqp_nominal_b16_substeps2", kick2, 16)):
        env_, tg_ = task_inputs(task_, B_, 120 + B_, 0.2)
        tables_ = task_._step_physics_batch.tables
        x_ = ss.pack_state(env_.physics)
        p_ = ss.pack_params(task_.model, env_.dyn, tg_)
        _, err_, _ = one_substep(tables_, x_, p_)
        assert err_ < 1e-3, (label, err_)
        max_abs_err = max(max_abs_err, err_)
        time_launch(label, tables_, x_, p_, phase="phase12")
        p12[label] = p8.pop(label)
        log(f"phase12 {label}: max|kernel-plain| on the state rows = "
            f"{err_:.3e}")

    def profiled(fn):
        """fn() once under torch.profiler: (wall ms, device ms, substep
        kernel ms, kernel launches)."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_:
            t_ = time.time()
            fn()
            torch.cuda.synchronize()
            wall_ = 1e3 * (time.time() - t_)
        ev_ = [e for e in prof_.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        return (wall_, sum(dev_us(e) for e in ev_) / 1e3,
                sum(dev_us(e) for e in ev_
                    if "bez_substep_kernel" in e.key) / 1e3,
                sum(e.count for e in ev_), ev_)

    engine.substep = plain_forbidden
    try:
        # 12b: the SQP bench's timing, CUDA events around each of 5 solves
        # and around each stage inside them.
        stage_events = {}

        def timed(obj, name, key):
            fn = getattr(obj, name)

            def wrapped(*a, **k):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **k)
                e1.record()
                stage_events.setdefault(key, []).append((e0, e1))
                return out
            return wrapped

        bench = {}
        for iters in (1, 2):
            solver_b = SQPSolver(kick2, SQPConfig(
                horizon=H_B, iterations=iters, relinearize_every=iters))
            solver_b.solve(env_b, zero_b)                      # warm-up
            solver_b._lin_dyn = timed(solver_b, "_lin_dyn", "linearize")
            solver_b._cost_grads = timed(solver_b, "_cost_grads",
                                         "cost_grads")
            solver_b._bf_pass = timed(solver_b, "_bf_pass", "bf_pass")
            real_seq = sqp_mod.sequential_backward
            sqp_mod.sequential_backward = timed(sqp_mod,
                                                "sequential_backward",
                                                "backward")
            stage_events.clear()
            solve_ms = []
            try:
                torch.cuda.synchronize()
                ss.substep.launches = 0
                for _ in range(5):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    a_b, _, info_b = solver_b.solve(env_b, zero_b)
                    e1.record()
                    torch.cuda.synchronize()
                    solve_ms.append(e0.elapsed_time(e1))
                n_b = ss.substep.launches
            finally:
                sqp_mod.sequential_backward = real_seq
            # One nominal rollout, then one line search per iteration: H
            # control steps of 2 substeps each.
            assert n_b == 5 * 2 * H_B * (1 + iters), (iters, n_b)
            assert torch.isfinite(a_b).all()
            st_ms = {k: sum(e0.elapsed_time(e1) for e0, e1 in v) / 5
                     for k, v in stage_events.items()}
            st_ms["line_search_forward"] = st_ms.pop("bf_pass") \
                - st_ms["backward"]
            med = sorted(solve_ms)[2]
            bench[iters] = {"ms_per_batch": med, "ms_per_solve": med / S_B,
                            "launches_per_solve": n_b // 5, **st_ms}
            launches_by_path[f"sqp_bench_iters{iters}"] = n_b
            log(f"phase12 SQP bench S={S_B} H={H_B} substeps 2 iterations="
                f"{iters} relinearize_every={iters}: median of 5 ms_per_batch"
                f"={med:.2f} ms_per_solve={med / S_B:.3f} (all "
                + " ".join(f"{v:.1f}" for v in solve_ms) + "); per batch "
                + " ".join(f"{k}_ms={v:.2f}" for k, v in st_ms.items())
                + f"; launches per batch {n_b // 5} | {card_line()}")
        solver_b = SQPSolver(kick2, SQPConfig(horizon=H_B, iterations=1))
        t_p12, dev12, sub12, n12, ev12 = profiled(
            lambda: solver_b.solve(env_b, zero_b))
        log(f"phase12 profile of one SQP solve S={S_B}: wall_ms={t_p12:.2f} "
            f"device_ms={dev12:.2f} substep_kernel_ms={sub12:.2f} kernels="
            f"{n12} idle_share_profiled={1 - dev12 / t_p12:.3f} "
            f"idle_share_vs_median="
            f"{1 - dev12 / bench[1]['ms_per_batch']:.3f}")
        for e in sorted(ev12, key=dev_us, reverse=True)[:6]:
            log(f"phase12   {dev_us(e) / 1e3:8.3f} ms {e.count:6d}x  "
                f"{e.key[:90]}")

        # 12c: serving sqp-policy at runs/Bez_Kick/sqp_kick_eval.json's
        # config.  One tick first, and the projection.
        sqp_kw = dict(num_envs=64, horizon=32, iterations=1, substeps=4,
                      warm_reg=0.5, policy_prior=str(kick_ckpt))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        kick_eval.eval_sqp_policy(steps=1, **sqp_kw)
        torch.cuda.synchronize()
        one_tick = time.time() - t0
        n_pol = ticks_by_path["policy Bez_Kick_best"]
        log(f"phase12 sqp-policy one tick (set-up included) s={one_tick:.2f}"
            f"; projection for phase 6's {n_pol} policy ticks: "
            f"{one_tick * n_pol:.0f}"
            f" s")
        # Bars about 3 binomial standard deviations (n=64) from the
        # artifact's 0.953 / 1.0 / 0.156.
        res_sqp = run_eval("phase12", "sqp_policy_eval",
                           lambda: kick_eval.eval_sqp_policy(steps=600,
                                                             **sqp_kw),
                           4 * (3 * 32 + 1),
                           [("success_rate", ">=", 0.87),
                            ("kicked_rate", ">=", 0.95),
                            ("fall_rate", "<=", 0.29)], max_ticks=600)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"phase12 sqp-policy peak memory {peak_gb:.2f} GB "
            f"(torch.cuda.max_memory_allocated) | {card_line()}")
        # Where an sqp-policy tick's time goes: one tick (policy rollout,
        # solve, env step) at the eval's config, profiled.
        task4s = KickTask(TaskConfig(substeps=4), device="cuda")
        player4s = PpoPlayerContinuous(task4s, checkpoint_path=str(kick_ckpt))
        solver4s = SQPSolver(task4s, SQPConfig(horizon=32, iterations=1,
                                               warm_reg=0.5))
        g4s = torch.Generator(device=dev).manual_seed(0)
        env4s = task4s.reset(g4s, 64)

        def sqp_tick():
            nom = kick_eval.policy_rollout(task4s, player4s, env4s, 32)
            a_, _, _ = solver4s.solve(env4s, SQPState(nominal=nom))
            task4s.step_batch(env4s, a_, g4s)

        sqp_tick()
        w_, d_, k_, n_, _ = profiled(sqp_tick)
        tick_c = ms_per_tick["sqp_policy_eval"]
        log(f"phase12 profile of one sqp-policy tick S=64: wall_ms={w_:.2f}"
            f" device_ms={d_:.2f} substep_kernel_ms={k_:.2f} kernels={n_} "
            f"idle_share_profiled={1 - d_ / w_:.3f} idle_share_vs_eval_tick="
            f"{1 - d_ / tick_c:.3f} (eval ms_per_tick={tick_c:.2f})")

        # 12d: the hybrid, eval_mppi(use_sqp=True) at phase 3's MPPI config
        # (K=32, H=32, sigma 0.15, substeps 2), S=16, 20 chained ticks;
        # every SQP solve's cost at most its MPPI nominal's.
        costs12 = []
        real_sqp_solve = SQPSolver.solve

        def checked_solve(self, env, st, gen=None):
            base = []
            real_roll = SQPSolver._rollout

            def roll(e, U):
                out = real_roll(self, e, U)
                base.append(out[1])
                return out

            self._rollout = roll
            try:
                out = real_sqp_solve(self, env, st, gen)
            finally:
                del self._rollout
            costs12.append((base[0], out[2]["cost"]))
            assert torch.isfinite(out[0]).all()
            return out

        SQPSolver.solve = checked_solve
        try:
            res_h = run_eval("phase12", "hybrid_20_ticks",
                             lambda: kick_eval.eval_mppi(
                                 num_envs=16, steps=20, horizon=32,
                                 num_samples=32, sigma=0.15,
                                 temperature=0.05, substeps=2,
                                 use_sqp=True),
                             2 * (32 + 2 * 32 + 1), [], max_ticks=20,
                             num_envs=16)
        finally:
            SQPSolver.solve = real_sqp_solve
        hyb = HybridSolver(kick2, MPPIConfig(horizon=32, num_samples=32,
                                             sigma=0.15, temperature=0.05),
                           SQPConfig(horizon=32, iterations=1))
        g_h = torch.Generator(device=dev).manual_seed(0)
        env_h = kick2.reset(g_h, 16)
        hst = hyb.init_state(16)

        def hybrid_tick():
            a_, _, _ = hyb.solve(env_h, hst, g_h)
            kick2.step_batch(env_h, a_, g_h)

        hybrid_tick()
        w_, d_, k_, n_, _ = profiled(hybrid_tick)
        tick_h = ms_per_tick["hybrid_20_ticks"]
        log(f"phase12 profile of one hybrid tick S=16: wall_ms={w_:.2f} "
            f"device_ms={d_:.2f} substep_kernel_ms={k_:.2f} kernels={n_} "
            f"idle_share_profiled={1 - d_ / w_:.3f} idle_share_vs_eval_tick="
            f"{1 - d_ / tick_h:.3f} (eval ms_per_tick={tick_h:.2f})")
        worse = sum(int((c > b + 1e-6).sum()) for b, c in costs12)
        better = sum(int((c < b).sum()) for b, c in costs12)
        assert costs12 and worse == 0, worse
        log(f"phase12 hybrid: {len(costs12)} SQP solves, polished cost below "
            f"the MPPI nominal's in {better} of {16 * len(costs12)} solves, "
            f"above in {worse}; ms_per_tick="
            f"{ms_per_tick['hybrid_20_ticks']:.2f} | {card_line()}")
    finally:
        engine.substep = real_substep
    log(f"phase12 s={time.time() - t12:.1f}")

    # ---------------- phase 13: the standalone classical walk ---------------
    import os
    import shutil
    import tempfile

    from bez_isaacgym_tpu_torch.control.camera import Camera
    from bez_isaacgym_tpu_torch.control.transformation import Transformation
    from bez_isaacgym_tpu_torch.eval import walk_standalone
    from bez_isaacgym_tpu_torch.models.robot import build_robot_model
    from bez_isaacgym_tpu_torch.models.urdf import parse_urdf
    from bez_isaacgym_tpu_torch.native import bindings as native

    t13 = time.time()
    # The JAX eval's own initial states at seeds 0 and 1, 64 envs each
    # (tests/torch_walk_same_states.py --write), one eval of 128 envs.
    same_w = load_env_states(
        root / "tests" / "data" / "walk_jax_reset_states.npz")
    B13 = same_w.progress.shape[0]
    assert B13 == 128, B13
    walk13 = WalkTask(device="cuda")
    tables13 = walk13._step_physics_batch.tables
    m13 = walk13.model
    assert (m13.nb, m13.nq, len(m13.cpoint_body)) == (19, 18, 96), m13.nb
    assert not tables13.cfg.has_ball and tables13.cfg.substeps == 4

    # 13a: the kernel at this path's batch (B=128) and at one seed's (B=64)
    # from those states, against its plain version at phase 1's bars.
    g13 = torch.Generator(device=dev).manual_seed(13)
    for B_ in (B13, 64):
        env_ = tree_map(lambda v: v[:B_].contiguous(), same_w)
        acts_ = 0.2 * torch.randn((B_, 18), generator=g13, device=dev)
        tg_ = walk13._pre_physics(env_, acts_, g13)[1]
        x_ = ss.pack_state(env_.physics)
        p_ = ss.pack_params(m13, env_.dyn, tg_)
        _, err_, _ = one_substep(tables13, x_, p_)
        assert err_ < 1e-3, (B_, err_)
        max_abs_err = max(max_abs_err, err_)
        log(f"phase13 walk from the JAX states one substep B={B_}: "
            f"max|kernel-plain| on the state rows = {err_:.3e}")
        check_steps(m13, walk13.scene, env_.physics, env_.dyn, tg_, 5,
                    f"walk from the JAX states B={B_} 5 steps",
                    phase="phase13")
        time_launch(f"walk_standalone_b{B_}", tables13, x_, p_,
                    phase="phase13")

    # 13b: eval_classical_walk from those states through its entry point,
    # the plain engine's substep forbidden.  Host time in the leg plans
    # (_plan_legs: one call per step, the step's plans side by side in the
    # worker processes) and in the feedforward (_ff_plan, one per leg),
    # and torch.profiler over a window of 50 control steps.
    plan_calls, ff_s = [], []       # (step, legs, wall s); wall s per leg
    W0, WN = 300, 50
    win = {"step": 0, "prof": None, "t0": 0.0, "wall": None}
    real_plan_legs = walk_standalone._plan_legs
    real_ff_plan = walk_standalone._ff_plan

    def timed_plan_legs(requests, pool):
        t_ = time.time()
        out = real_plan_legs(requests, pool)
        if requests:
            plan_calls.append((win["step"], len(requests), time.time() - t_))
        return out

    def timed_ff_plan(*a):
        t_ = time.time()
        out = real_ff_plan(*a)
        ff_s.append(time.time() - t_)
        return out

    def windowed_step(self, *a, **k):
        out = BezTask.step_batch(self, *a, **k)   # run_eval's counted one
        win["step"] += 1
        if win["step"] == W0:
            torch.cuda.synchronize()
            win["prof"] = profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])
            win["prof"].start()
            win["t0"] = time.time()
        elif win["step"] == W0 + WN:
            torch.cuda.synchronize()
            win["wall"] = time.time() - win["t0"]
            win["prof"].stop()
        return out

    resets13 = []

    def first_from_jax_w(self, gen, n, dr_step=0):
        resets13.append(n)
        if len(resets13) == 1:
            assert n == B13, n
            return same_w
        return BezTask.reset(self, gen, n, dr_step)

    # The JAX package's f32 run from these states on the CPU (`python
    # tests/torch_walk_same_states.py`): win 82, fall 13, stray 26 and
    # timeout 7 of 128 (seed 0: 41 / 7 / 13 / 3; seed 1: 41 / 6 / 13 / 4).
    # The bars are 3 binomial standard deviations (n=128) on each side.
    bars13 = []
    for metric, count in (("win_rate", 82), ("fall_rate", 13),
                          ("stray_rate", 26), ("timeout_rate", 7)):
        p_ref = count / B13
        sd3 = 3.0 * math.sqrt(p_ref * (1.0 - p_ref) / B13)
        bars13 += [(metric, ">=", p_ref - sd3), (metric, "<=", p_ref + sd3)]
    label13 = "standalone walk from the JAX eval's states, seeds 0-1"
    engine.substep = plain_forbidden
    WalkTask.reset = first_from_jax_w
    WalkTask.step_batch = windowed_step
    walk_standalone._plan_legs = timed_plan_legs
    walk_standalone._ff_plan = timed_ff_plan
    try:
        t_eval = time.time()
        res13 = run_eval("phase13", label13,
                         lambda: walk_standalone.eval_classical_walk(
                             num_envs=B13,
                             plan_workers=walk_standalone.host_plan_workers()),
                         4, bars13, max_ticks=624, num_envs=B13)
        wall13 = time.time() - t_eval
    finally:
        engine.substep = real_substep
        del WalkTask.reset, WalkTask.step_batch
        walk_standalone._plan_legs = real_plan_legs
        walk_standalone._ff_plan = real_ff_plan
        if win["prof"] is not None and win["wall"] is None:
            win["prof"].stop()
    assert resets13 and resets13[0] == B13, resets13
    ticks13 = ticks_by_path[label13]
    legs13 = sum(n for _, n, _ in plan_calls)
    plan13 = sum(s for _, _, s in plan_calls)
    burst = max(plan_calls, key=lambda c: c[1])
    assert len(ff_s) <= legs13 and res13["replanned_segments"] < legs13
    log(f"phase13 {label13}: win {res13['win_rate']:.6f} (the JAX package's"
        f" f32 run from these states 82/128 = 0.640625; the README's TPU "
        f"figure 60.9-62.5 % is a reference, not a bar); "
        f"mean_min_goal_dist_m={res13['mean_min_goal_dist_m']:.6f} (JAX f32 "
        f"0.06825 / 0.05420 at seeds 0 / 1) mean_final_goal_dist_m="
        f"{res13['mean_final_goal_dist_m']:.6f} (JAX 0.09030 / 0.06893) "
        f"replanned_segments={res13['replanned_segments']} (JAX 71 + 73)")
    log(f"phase13 {label13}: eval wall s={wall13:.2f} for {ticks13} steps "
        f"({1e3 * wall13 / ticks13:.2f} ms per control step, "
        f"{ms_per_tick[label13]:.2f} by CUDA events); {legs13} leg plans "
        f"in {len(plan_calls)} steps, {plan13:.2f} s of wall in _plan_legs "
        f"({1e3 * plan13 / legs13:.1f} ms per leg; the largest step "
        f"{burst[1]} legs at step {burst[0]} in {burst[2]:.2f} s), "
        f"_ff_plan {len(ff_s)} legs {1e3 * sum(ff_s) / len(ff_s):.2f} ms "
        f"per leg; the rest of the loop {wall13 - plan13 - sum(ff_s):.2f} s"
        f" | {card_line()}")
    if win["wall"] is not None:
        ev13 = [e for e in win["prof"].key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        d13 = sum(dev_us(e) for e in ev13) / 1e3
        k13 = sum(dev_us(e) for e in ev13
                  if "bez_substep_kernel" in e.key) / 1e3
        legs_w = sum(n for s, n, _ in plan_calls if W0 <= s < W0 + WN)
        log(f"phase13 profile of control steps {W0}-{W0 + WN - 1} (under the"
            f" profiler): wall_ms_per_step={1e3 * win['wall'] / WN:.2f} "
            f"device_ms_per_step={d13 / WN:.3f} substep_kernel_ms_per_step="
            f"{k13 / WN:.3f} kernels_per_step="
            f"{sum(e.count for e in ev13) / WN:.1f} leg plans in the window="
            f"{legs_w} idle_share={1 - d13 / (1e3 * win['wall']):.4f}")
    else:
        log(f"phase13 profile: the eval ended after {ticks13} steps, before "
            f"the window's end at step {W0 + WN}")

    # 13c: the camera model on this machine: tests/test_viz_misc.py's round
    # trip, then a head-height camera pitched down: pixel -> floor -> pixel.
    cam = Camera(Transformation(position=[0, 0, 0.5]))
    assert np.allclose(cam.world_to_pixel([2.0, 0.0, 0.5]), [320, 240],
                       atol=1e-6)
    assert cam.world_to_pixel([-1.0, 0.0, 0.5]) is None
    ground = cam.find_floor_coordinate(320, 400)
    assert ground is not None and ground[0] > 0 and abs(ground[2]) < 1e-9
    cam_err = float(np.abs(cam.world_to_pixel(ground) - [320, 400]).max())
    head = Camera(Transformation(position=[0.1, -0.2, 0.45],
                                 quaternion=[0.0, np.sin(0.3), 0.0,
                                             np.cos(0.3)]))
    n_floor = 0
    for u in np.linspace(0.0, 640.0, 9):
        for v in np.linspace(0.0, 480.0, 7):
            g_ = head.find_floor_coordinate(u, v)
            if g_ is None:
                continue
            n_floor += 1
            cam_err = max(cam_err, float(np.abs(
                head.world_to_pixel(g_) - [u, v]).max()))
    assert n_floor > 0 and cam_err < 1e-4, (n_floor, cam_err)
    log(f"phase13 camera: pixel -> floor -> pixel round trip on {n_floor + 1}"
        f" pixels, max error {cam_err:.3e} px")

    # 13d: the native C++ libraries built from native/ with this machine's
    # compiler (make), their C++ unit tests, and the native URDF compiler
    # against the port's Python compile on every Bez asset variant.
    shutil.rmtree(native.BUILD_DIR, ignore_errors=True)
    cxx = os.environ.get("CXX", "g++")
    cxx_v = subprocess.run([cxx, "--version"], capture_output=True,
                           text=True).stdout.splitlines()[0]
    t_ = time.time()
    out_dir = native.build()
    build_s = time.time() - t_
    for exe in native.TESTS:
        r_ = subprocess.run([str(out_dir / exe)], capture_output=True,
                            text=True)
        assert r_.returncode == 0 and "0 failed" in r_.stdout, r_.stdout
    worst = 0.0
    with tempfile.TemporaryDirectory() as tmp:
        for variant in ("stl", "box", "box_sensor", "stl_sensor"):
            text = bez.load_spec(variant).to_urdf()
            path = Path(tmp) / f"bez_{variant}.urdf"
            path.write_text(text)
            nat = native.compile_urdf_native(str(path))
            py = build_robot_model(parse_urdf(text))
            assert (nat["nb"], nat["nq"]) == (py.nb, py.nq), variant
            assert nat["joint_names"] == py.joint_names
            assert nat["body_names"] == py.body_names
            assert np.array_equal(nat["parent"], py.parent)
            limits = np.stack([py.dof_lower, py.dof_upper, py.dof_effort,
                               py.dof_velocity], axis=1)
            for key in ("tree_pos", "tree_rot", "axis", "mass", "com",
                        "inertia", "limits"):
                want = limits if key == "limits" else getattr(py, key)
                worst = max(worst, float(np.abs(nat[key] - want).max()))
    assert worst <= 1e-12, worst
    log(f"phase13 native: make -C native BUILD={out_dir.relative_to(root)} "
        f"CXXFLAGS='{native.CXXFLAGS}' with {cxx} ({cxx_v}) "
        f"s={build_s:.2f} ({', '.join(native.LIBRARIES)}); C++ unit tests "
        f"{' and '.join(native.TESTS)} pass; compile_urdf_native against "
        f"the Python compile on 4 asset variants: max diff {worst:.1e}")
    p13 = {"B": B13, "substeps": 4, "launches": launches_by_path[label13],
           "steps": ticks13, "ms": p8[f"walk_standalone_b{B13}"]["ms"],
           "bound_ms": p8[f"walk_standalone_b{B13}"]["bound_ms"]}
    log(f"phase13 s={time.time() - t13:.1f}")
    assert not misses, misses

    # ---------------- phase 14: two ranks sharing the card -----------------
    t14 = time.time()
    from bez_isaacgym_tpu_torch.parallel.distributed import spawn_ranks
    from bez_isaacgym_tpu_torch.parallel.mesh import rank_seed
    from bez_isaacgym_tpu_torch.viz import render as viz_render

    # (a, b, d) in two spawned ranks on cuda:0 over gloo; the kernel was
    # built in phase 0, so the ranks load it and build nothing.
    assert _build.library_path().exists()
    with tempfile.TemporaryDirectory() as tmp:
        res = spawn_ranks(phase14_rank, P14_RANKS, str(root), tmp)
        metric_rows = (Path(tmp) / "Bez_Kick" / "metrics.jsonl").read_text(
        ).splitlines()
    # Rank 0 alone logs: one row per iteration.
    assert [json.loads(r)["iter"] for r in metric_rows] == \
        list(range(1, P14_ITERS + 1)), metric_rows
    r0 = res[0]
    n_local = P14_ENVS // P14_RANKS
    per_iter = 4 * HORIZON
    for r in res:
        assert r["backend"] == "gloo" and r["device"] == "cuda:0", r
        assert [row["launches"] for row in r["rows"]] == \
            [per_iter] * P14_ITERS, (r["rank"], r["rows"])
    # Bit-identical ranks after the last iteration (each rank also checked
    # every iteration against rank 0 by broadcast).
    fin = [r["ts_final"] for r in res]
    for a_, b_ in zip([*fin[0][0].values(), *fin[0][1].mu.values(),
                       *fin[0][1].nu.values()],
                      [*fin[1][0].values(), *fin[1][1].mu.values(),
                       *fin[1][1].nu.values()]):
        assert torch.equal(a_, b_)
    log(f"phase14 layout: {P14_RANKS} ranks on one card ({r0['device']}), "
        f"backend {r0['backend']}, {n_local} envs each ({P14_ENVS} global), "
        f"kick substeps 4 with the ball, units (400, 200, 100), horizon "
        f"{HORIZON}, minibatch 32768 global; parameters and Adam state "
        f"bit-identical on both ranks after each of {P14_ITERS} iterations")

    # Iteration 1 against the single-process update on the concatenated
    # shards (each minibatch the union of the ranks' minibatches).
    it1 = phase14_iteration1([r["kept"] for r in res], kick_tr["nominal"])
    log("phase14 iteration 1 against the single-process update on the "
        f"concatenated shards ({P14_ENVS} envs, interleaved minibatches): "
        f"the first step's gradient |dg|/|g|={it1['grad_steps'][0]:.3e}, "
        "each step's: " + " ".join(f"{e_:.1e}" for e_ in it1["grad_steps"])
        + f"; running stats max|d| / (1e-4 |x| + 1e-6) = "
        f"{it1['stats_ratio']:.3f} (" + ", ".join(
            f"{k_} {v_:.2e}" for k_, v_ in it1["stats_rel"].items())
        + f"); |dparams|/|params|={it1['params_rel']:.3e} "
        f"|dupdate|/|update|={it1['update_rel']:.3e} max|dparam|="
        f"{it1['params_max']:.3e} (the steps' summed lr "
        f"{it1['sum_lr']:.3e}); Adam mu {it1['mu_rel']:.3e} nu "
        f"{it1['nu_rel']:.3e}; lr {it1['lr'][0]:.6e} / {it1['lr'][1]:.6e}; "
        f"share of |dparams|^2 in the first layer's columns of the "
        f"{it1['const_obs']} observations whose variance is under 1e-6: "
        f"{it1['const_share']:.4f}")
    # Each step's gradient differs by the f32 summation order only (2e-5
    # in norm over minibatches of 32,768 samples); the running stats by
    # f32 reductions over 131,072 samples in another order (1e-4
    # relative), Adam's moments likewise (1e-4).  The parameters are held
    # within twice the sum of the steps' learning rates (the JAX parity
    # tests' bar): Adam divides each gradient by its own RMS, and an
    # observation that is constant over the batch is normalized to f32
    # rounding noise whose sign follows the mean's last bit, so the first
    # layer's weights on it take full +-lr steps either way.
    assert max(it1["grad_steps"]) <= 2e-5, it1["grad_steps"]
    assert it1["stats_ratio"] <= 1.0, it1["stats_rel"]
    assert it1["mu_rel"] <= 1e-4 and it1["nu_rel"] <= 1e-4, it1
    assert it1["params_max"] <= 2 * it1["sum_lr"], it1
    assert it1["lr"][0] == it1["lr"][1], it1["lr"]

    # Time per iteration: steady = iterations 2..; frames/s per rank and
    # in total against phase 11's single-process run from scratch.
    keep = list(range(1, P14_ITERS))
    mean_r = [{k_: sum(r["ms"][k_][i] for i in keep) / len(keep)
               for k_ in ("rollout", "update", "iter")} for r in res]
    ar_r = [sum(r["rows"][i]["allreduce_host_ms"] for i in keep) / len(keep)
            for r in res]
    fps_r = [n_local * HORIZON / (m_["iter"] / 1e3) for m_ in mean_r]
    fps_tot = sum(fps_r)
    for r, m_, a_, f_ in zip(res, mean_r, ar_r, fps_r):
        log(f"phase14 rank {r['rank']}: steady iteration ms={m_['iter']:.2f}"
            f" (rollout {m_['rollout']:.2f}, update {m_['update']:.2f}, of "
            f"which all_reduce host ms {a_:.2f} in "
            f"{r['rows'][-1]['allreduce_calls']} calls), first iteration ms="
            f"{r['ms']['iter'][0]:.2f}; frames_per_s={f_:.0f}; substep "
            f"launches per iteration {[w['launches'] for w in r['rows']]}; "
            f"run s={r['run_s']:.2f}; all_reduce of the "
            f"{r['grad_buffer_floats']}-float gradient buffer "
            f"{r['allreduce_ms_grad_buffer']:.3f} ms")
    log(f"phase14 two ranks: frames_per_s total={fps_tot:.0f} against "
        f"phase 11's one process from scratch {sc['fps']:.0f} "
        f"(iteration {sc['ms']['iter']:.2f} ms): {fps_tot / sc['fps']:.3f}x"
        f" | {card_line()}")
    log(f"phase14 kernel B={n_local} substeps=4 while the other rank also "
        f"launches: " + ", ".join(
            f"rank {r['rank']} {r['kernel_ms_b2048']:.5f} ms" for r in res)
        + f" (bound_ms {r0['bound_ms_b2048']:.6f}; one process alone: "
        f"phase 11's B={B_TR} {p11['nominal']['ms']:.5f}, phase 1's B=2048 "
        f"at substeps 2 {ms_k64:.5f})")
    log(f"phase14 profile of one rollout step, rank 0 (B={n_local}, the "
        f"policy and step_batch):\n{r0['profile']}")
    log("phase14 rollout step with both ranks on the card: " + ", ".join(
        f"rank {r['rank']} wall_ms={r['step_wall_ms']:.3f} device_ms="
        f"{r['step_device_ms']:.3f} idle_share="
        f"{1 - r['step_device_ms'] / r['step_wall_ms']:.3f}" for r in res)
        + f" (phase 11's one process: {sc['ms']['rollout'] / HORIZON:.3f} "
        f"ms per rollout step at B={B_TR})")

    # (b) each rank's MPPI actions against a single-process solve of its
    # slice with its noise (the rank's generator rebuilt here).
    mtask1 = KickTask(TaskConfig(substeps=2), device="cuda")
    msolver = MPPISolver(mtask1, MPPIConfig(horizon=32, num_samples=32))
    envs_all = mtask1.reset(torch.Generator(device=dev).manual_seed(
        P14_MPC_SEED), P14_MPC_S)
    s_local = P14_MPC_S // P14_RANKS
    err_mpc = 0.0
    for r in res:
        rows_ = slice(r["rank"] * s_local, (r["rank"] + 1) * s_local)
        g_ = torch.Generator(device=dev).manual_seed(
            rank_seed(P14_MPC_SEED, r["rank"]))
        a1, _, _ = msolver.solve(tree_map(lambda x: x[rows_], envs_all),
                                 msolver.init_state(s_local), g_)
        err_mpc = max(err_mpc, float((a1.cpu() - r["mpc_actions"]).abs()
                                     .max()))
        assert torch.equal(r["mpc_global"], res[0]["mpc_global"])
        assert r["mpc_launches"] == 2 * 32, r["mpc_launches"]
    assert err_mpc <= 1e-6, err_mpc
    log(f"phase14 data-parallel MPPI S={P14_MPC_S} = {P14_RANKS} x "
        f"{s_local}, K=32, H=32, substeps 2: max|rank - single-process "
        f"solve of its slice| = {err_mpc:.3e}; gathered actions equal on "
        f"both ranks; ms per tick (solve + step) " + ", ".join(
            f"rank {r['rank']} {r['mpc_ms_per_tick']:.2f}" for r in res)
        + f" (phase 3's S=64 in one process {ms_tick:.2f})")

    # (c) viz: skeleton segments and mesh triangles from card states
    # against the same states on the CPU; the render path without
    # matplotlib raises before the first step.
    import importlib.util
    env_v = kick_tr["nominal"].reset(torch.Generator(device=dev)
                                     .manual_seed(141), 4)
    err_viz = 0.0
    for i in range(4):
        ph = tree_map(lambda x: x[i], env_v.physics)
        ph_cpu = tree_map(lambda x: x.cpu(), ph)
        err_viz = max(err_viz, float(np.abs(
            viz_render._skeleton(stl, ph) - viz_render._skeleton(stl, ph_cpu)
        ).max()))
        tris_k, _ = viz_render._mesh_polys_world(stl, ph)
        tris_c, _ = viz_render._mesh_polys_world(stl, ph_cpu)
        assert len(tris_k) == len(tris_c) > 1000
        err_viz = max(err_viz, float(np.abs(np.stack(tris_k)
                                            - np.stack(tris_c)).max()))
    assert err_viz <= 1e-5, err_viz
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    steps_v = [0]

    def counted(self, *a, **k):
        steps_v[0] += 1
        return real_step_batch(self, *a, **k)

    with tempfile.TemporaryDirectory() as tmp:
        out_gif = str(Path(tmp) / "episode.gif")
        play_v = Runner(parse_overrides([
            "task=bez_kick", "test=True", "num_envs=4", f"render={out_gif}",
            f"output_dir={tmp}", "multi_chip=False"]))
        BezTask.step_batch = counted
        try:
            if has_mpl:
                play_v.play(2)
                assert Path(out_gif).stat().st_size > 1000
                viz_what = "matplotlib present: a 2-step episode rendered"
            else:
                try:
                    play_v.play(2)
                    raise AssertionError("render= without matplotlib ran")
                except ImportError as e:
                    assert "matplotlib" in str(e), e
                assert steps_v[0] == 0, steps_v
                viz_what = ("no matplotlib here: Runner.play(render=...) "
                            "raised the ImportError naming it before the "
                            "first step")
        finally:
            BezTask.step_batch = real_step_batch
    log(f"phase14 viz: skeleton segments and {len(tris_k)} mesh triangles "
        f"of 4 card states against the CPU, max diff {err_viz:.3e} m; "
        f"{viz_what}")
    launches_by_path["dp_ppo_per_rank_3_iterations"] = sum(
        w["launches"] for w in r0["rows"])
    p14 = {"B": n_local, "substeps": 4, "ranks_sharing_the_card":
           P14_RANKS, "launches_per_rank_per_iteration": per_iter,
           "ms": {f"rank{r['rank']}": r["kernel_ms_b2048"] for r in res},
           "bound_ms": r0["bound_ms_b2048"]}
    log(f"phase14 s={time.time() - t14:.1f}")

    kernels = [{
        "name": "substep",
        "route": "cuda",
        "source": "bez_isaacgym_tpu_torch/csrc/substep.cu",
        "replaces": "bez_isaacgym_tpu/ops/pallas_step.py:126",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms_k,
        "plain_ms": ms_p,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "ms_b2048": ms_k64,
        "ms_b2560_substeps4": ms_sub4[2560],
        "ms_b6144_substeps4": ms_sub4[6144],
        "bound_ms_b2048": b2048.ms,
        **{f"{m}_{k}": v[m] for k, v in p8.items() for m in ("ms",
                                                             "bound_ms")},
        **{f"{m}_b4096_substeps4_{k}": v[m] for k, v in p11.items()
           for m in ("ms", "bound_ms")},
        **{f"{m}_{k}": v[m] for k, v in p12.items() for m in ("ms",
                                                             "bound_ms")},
        "walk_standalone": p13,
        "dp_two_ranks_one_card": p14,
        "launches_by_path": launches_by_path,
        "envs_per_block": lc.envs_per_block,
    }]
    log(f"chip_smoke total s={time.time() - t_start:.1f}")
    assert all(math.isfinite(k["ms"]) for k in kernels)
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
