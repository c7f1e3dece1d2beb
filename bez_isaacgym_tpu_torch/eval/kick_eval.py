"""Closed-loop kick evaluation: does the controller actually kick?

Port of `bez_isaacgym_tpu/eval/kick_eval.py`.  Runs a trained policy, MPPI
around a policy prior or a keyframe skill, the hybrid MPPI + SQP solver, or
the SQP polishing a policy rollout, on S parallel kick envs for one episode
horizon and reports ball progress toward the goal, success
rate (ball driven >= `success_dist` toward the goal), kick, scoring and
fall rates, over each env's first episode.  The physics runs through the
CUDA substep kernel on the card.  Per-env tallies stay on the device; the
host reads one flag per tick, to stop once every env has finished.

Usage:
    python -m bez_isaacgym_tpu_torch.eval.kick_eval \\
        --checkpoint runs/Bez_Kick/Bez_Kick_best.ckpt
    python -m bez_isaacgym_tpu_torch.eval.kick_eval --solver mppi \\
        --policy-prior runs/Bez_Kick/Bez_Kick_best.ckpt --substeps 4 ...
    python -m bez_isaacgym_tpu_torch.eval.kick_eval --solver sqp-policy \\
        --warm-reg 0.5
    python -m bez_isaacgym_tpu_torch.eval.kick_eval --solver hybrid
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from bez_isaacgym_tpu_torch import resolve_device
from bez_isaacgym_tpu_torch.tasks.base import EnvState, StepOutput, TaskConfig
from bez_isaacgym_tpu_torch.tasks.kick import KickTask

class _Tally:
    """Per-env tallies of each env's FIRST episode, on the device (results
    freeze at the env's first done)."""

    def __init__(self, state: EnvState):
        n, dev = state.goal.shape[0], state.goal.device
        self.goal = state.goal                               # (S,2)
        self.init_goal_dist = torch.linalg.norm(
            self.goal - state.physics.ball_pos[:, :2], dim=-1)
        self.finished = torch.zeros(n, dtype=torch.bool, device=dev)
        self.progress = torch.zeros(n, dtype=torch.float32, device=dev)
        self.scored = torch.zeros(n, dtype=torch.bool, device=dev)
        self.fell = torch.zeros(n, dtype=torch.bool, device=dev)
        self.ep_steps = torch.zeros(n, dtype=torch.int32, device=dev)

    def update(self, out: StepOutput) -> bool:
        """Fold one step in; True once every env has finished (the one host
        sync of a tick)."""
        ph = out.state.physics
        goal_dist = torch.linalg.norm(self.goal - ph.ball_pos[:, :2], dim=-1)
        live = ~self.finished
        self.progress = torch.where(
            live, torch.maximum(self.progress,
                                self.init_goal_dist - goal_dist),
            self.progress)
        d = out.done & live
        self.scored |= d & (goal_dist < 0.05)
        self.fell |= d & (ph.base_pos[:, 2] < 0.275)
        self.ep_steps += live.to(torch.int32)
        self.finished |= out.done
        return bool(self.finished.all())

    def rates(self, success_dist: float) -> dict:
        prog = self.progress.cpu().numpy().astype(np.float64)
        return {
            "mean_ball_progress_m": float(prog.mean()),
            "median_ball_progress_m": float(np.median(prog)),
            "success_rate": float((prog >= success_dist).mean()),
            "kicked_rate": float((prog >= 0.3).mean()),
            "score_rate": float(self.scored.float().mean()),
            "fall_rate": float(self.fell.float().mean()),
            "mean_ep_steps": float(self.ep_steps.double().mean()),
        }


def eval_policy(checkpoint: str, num_envs: int = 64, steps: int = 600,
                success_dist: float = 1.0, seed: int = 0,
                deterministic: bool = True, use_kernel: bool = True,
                device="cuda"):
    """use_kernel=False steps the plain engine on the card too (to tell
    the kernel from the rest of the port when a result is off)."""
    from bez_isaacgym_tpu_torch.rl.players import PpoPlayerContinuous

    dev = resolve_device(device)
    task = KickTask(TaskConfig(substeps=4, use_kernel=use_kernel),
                    device=dev)
    player = PpoPlayerContinuous(task, checkpoint_path=checkpoint, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = task.reset(gen, num_envs)
    # The first obs observes the reset states (no zero-action step).
    zero = torch.zeros((num_envs, task.num_actions), dtype=torch.float32,
                       device=dev)
    obs, state = task.observe(state, zero)
    tally = _Tally(state)
    for _ in range(steps):
        # Sampling, when asked, draws from a key-0 generator each step, as
        # the JAX eval passes PRNGKey(0) to every act.
        actions = player.get_action(obs, deterministic)
        out = task.step_batch(state, actions, gen)
        state, obs = out.state, out.obs
        if tally.update(out):
            break
    return {"num_envs": num_envs, **tally.rates(success_dist)}


def eval_mppi(num_envs: int = 64, steps: int = 600, success_dist: float = 1.0,
              seed: int = 0, horizon: int = 32, num_samples: int = 64,
              sigma: float = 0.25, temperature: float = 0.05,
              substeps: int = 2, warm_skill: str = "",
              use_sqp: bool = False, done_penalty: float = 10.0,
              policy_prior: str = "", balance_weight: float = 0.0,
              terminal_balance_weight: float = 0.0,
              elite: bool = False, zero_nominal_sample: bool = False,
              recovery_samples: int = 0, recovery_sigma: float = 0.1,
              recovery_gate: float = 0.0, use_kernel: bool = True,
              device="cuda"):
    """Closed-loop MPC kick eval.

    warm_skill: keyframe skill (e.g. "simulation_rightkick") used as a
    receding-horizon reference nominal: at tick t the solver's nominal is
    re-seeded with the skill window [t, t+H).
    policy_prior: PPO checkpoint; rollouts run closed-loop around the
    policy's deterministic action and MPPI samples residuals.
    use_sqp: polish the MPPI nominal with the SQP stage (HybridSolver, one
    Gauss-Newton iteration per tick).
    use_kernel=False steps the plain engine on the card too.
    """
    from bez_isaacgym_tpu_torch.solvers.hybrid import HybridSolver
    from bez_isaacgym_tpu_torch.solvers.mppi import (MPPIConfig, MPPISolver,
                                                     MPPIState)
    from bez_isaacgym_tpu_torch.solvers.sqp import SQPConfig

    dev = resolve_device(device)
    task = KickTask(TaskConfig(substeps=substeps, use_kernel=use_kernel),
                    device=dev)
    mppi_cfg = MPPIConfig(horizon=horizon, num_samples=num_samples,
                          sigma=sigma, temperature=temperature,
                          done_penalty=done_penalty,
                          balance_weight=balance_weight,
                          terminal_balance_weight=terminal_balance_weight,
                          elite=elite,
                          zero_nominal_sample=zero_nominal_sample,
                          recovery_samples=recovery_samples,
                          recovery_sigma=recovery_sigma,
                          recovery_gate=recovery_gate)
    prior_fn = None
    if policy_prior:
        from bez_isaacgym_tpu_torch.rl.players import PpoPlayerContinuous
        player = PpoPlayerContinuous(task, checkpoint_path=policy_prior,
                                     device=dev)
        prior_fn = lambda obs: player.get_action(obs, True)  # noqa: E731
    if use_sqp:
        hybrid = HybridSolver(task, mppi_cfg,
                              SQPConfig(horizon=horizon, iterations=1),
                              prior_fn=prior_fn)
        solver = hybrid.mppi
    else:
        hybrid = None
        solver = MPPISolver(task, mppi_cfg, prior_fn=prior_fn)

    warm_plan = None
    if warm_skill:
        from bez_isaacgym_tpu_torch.control.warmstart import skill_warm_starts
        # The skill window of every tick, (steps, H, nq), uploaded once.
        warm_plan = torch.as_tensor(
            skill_warm_starts(task, warm_skill, horizon,
                              [t / 60.0 for t in range(steps)]), device=dev)

    gen = torch.Generator(device=dev).manual_seed(seed)
    noise_gen = torch.Generator(device=dev).manual_seed(seed + 1)
    state = task.reset(gen, num_envs)
    mppi = solver.init_state(num_envs)
    hstate = hybrid.init_state(num_envs) if hybrid is not None else None
    tally = _Tally(state)
    for t in range(steps):
        if warm_plan is not None:
            nominal = warm_plan[t].expand(
                (num_envs,) + warm_plan.shape[1:]).contiguous()
            if hybrid is not None:
                hstate = hybrid.warm_start(hstate, nominal)
            else:
                mppi = MPPIState(nominal=nominal)
        if hybrid is not None:
            actions, hstate, _ = hybrid.solve(state, hstate, noise_gen)
        else:
            actions, mppi, _ = solver.solve(state, mppi, noise_gen)
        out = task.step_batch(state, actions, gen)
        state = out.state
        if tally.update(out):
            break
    rates = tally.rates(success_dist)
    return {
        "num_envs": num_envs,
        "config": {"sigma": sigma, "temperature": temperature,
                   "num_samples": num_samples, "horizon": horizon,
                   "done_penalty": done_penalty,
                   "balance_weight": balance_weight,
                   "terminal_balance_weight": terminal_balance_weight,
                   "policy_prior": policy_prior, "warm_skill": warm_skill,
                   "use_sqp": use_sqp, "substeps": substeps,
                   "elite": elite,
                   "zero_nominal_sample": zero_nominal_sample,
                   "recovery_samples": recovery_samples,
                   "recovery_sigma": recovery_sigma,
                   "recovery_gate": recovery_gate},
        **{k: rates[k] for k in ("mean_ball_progress_m", "success_rate",
                                 "kicked_rate", "fall_rate")},
    }


def policy_rollout(task: KickTask, player, state: EnvState, horizon: int):
    """The deterministic policy unrolled `horizon` steps from `state`
    through the task's batched step (the kernel on the card): the absolute
    (S, H, nu) action sequence the SQP polishes."""
    zero = torch.zeros((state.goal.shape[0], task.num_actions),
                       dtype=torch.float32, device=state.goal.device)
    clip = task.cfg.clip_actions
    s, us = state, []
    for _ in range(horizon):
        obs, s = task.observe(s, zero)
        u = player.get_action(obs, True)
        uc = u.clamp(-clip, clip)
        uc = torch.cat([torch.zeros_like(uc[:, 0:2]), uc[:, 2:]], dim=-1)
        targets = torch.minimum(
            torch.maximum(uc + task.default_dof_pos, task.dof_lower),
            task.dof_upper)
        physics = task._step_physics_batch(s.dyn, s.physics, targets)
        s = s._replace(physics=physics, progress=s.progress + 1)
        us.append(u)
    return torch.stack(us, dim=1)


def eval_sqp_policy(num_envs: int = 16, steps: int = 200,
                    success_dist: float = 1.0, seed: int = 0,
                    horizon: int = 32, iterations: int = 1,
                    substeps: int = 4, warm_reg: float = 0.0,
                    balance_weight: float = 0.0,
                    policy_prior: str = "runs/Bez_Kick/Bez_Kick_best.ckpt",
                    use_kernel: bool = True, device="cuda"):
    """Closed-loop SQP with a policy-rollout warm start.

    Each tick the deterministic PPO policy is unrolled H steps from the
    current state into an absolute action sequence (through the task's
    batched step, the kernel on the card), the SQP/iLQR stage polishes it,
    and the first polished action is executed.
    use_kernel=False steps the plain engine on the card too.
    """
    from bez_isaacgym_tpu_torch.rl.players import PpoPlayerContinuous
    from bez_isaacgym_tpu_torch.solvers.sqp import (SQPConfig, SQPSolver,
                                                    SQPState)

    dev = resolve_device(device)
    task = KickTask(TaskConfig(substeps=substeps, use_kernel=use_kernel),
                    device=dev)
    player = PpoPlayerContinuous(task, checkpoint_path=policy_prior,
                                 device=dev)
    solver = SQPSolver(task, SQPConfig(horizon=horizon,
                                       iterations=iterations,
                                       warm_reg=warm_reg,
                                       balance_weight=balance_weight))
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = task.reset(gen, num_envs)
    tally = _Tally(state)
    for _ in range(steps):
        nominal = policy_rollout(task, player, state, horizon)
        actions, _, _ = solver.solve(state, SQPState(nominal=nominal))
        out = task.step_batch(state, actions, gen)
        state = out.state
        if tally.update(out):
            break
    rates = tally.rates(success_dist)
    return {
        "num_envs": num_envs,
        "config": {"solver": "sqp+policy_rollout", "horizon": horizon,
                   "iterations": iterations, "substeps": substeps,
                   "warm_reg": warm_reg, "balance_weight": balance_weight,
                   "policy_prior": policy_prior},
        **{k: rates[k] for k in ("mean_ball_progress_m", "success_rate",
                                 "kicked_rate", "fall_rate")},
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--solver", default="",
                    choices=["", "mppi", "hybrid", "sqp-policy"])
    ap.add_argument("--warm-skill", default="",
                    help="keyframe skill for receding warm starts, e.g. "
                         "simulation_rightkick")
    ap.add_argument("--num-envs", type=int, default=64)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--stochastic", action="store_true")
    ap.add_argument("--sigma", type=float, default=0.25)
    ap.add_argument("--temperature", type=float, default=0.05)
    ap.add_argument("--num-samples", type=int, default=64)
    ap.add_argument("--horizon", type=int, default=32)
    ap.add_argument("--policy-prior", default="",
                    help="PPO ckpt; MPPI samples residuals around the "
                         "policy's closed-loop actions")
    ap.add_argument("--balance-weight", type=float, default=0.0)
    ap.add_argument("--terminal-balance-weight", type=float, default=0.0)
    ap.add_argument("--elite", action="store_true",
                    help="execute the best-scoring sample instead of the "
                         "softmax average")
    ap.add_argument("--zero-nominal-sample", action="store_true",
                    help="always score the unperturbed nominal (with a "
                         "prior: the pure policy) as sample 0")
    ap.add_argument("--recovery-samples", type=int, default=0,
                    help="elite+prior only: absolute stand-biased sample "
                         "family size (abort-and-balance recovery mode)")
    ap.add_argument("--recovery-sigma", type=float, default=0.1)
    ap.add_argument("--recovery-gate", type=float, default=0.0)
    ap.add_argument("--warm-reg", type=float, default=0.0,
                    help="sqp-policy: quadratic tether to the policy-"
                         "rollout warm start (trust region)")
    ap.add_argument("--substeps", type=int, default=0,
                    help="env/rollout physics substeps (default: 4 for "
                         "sqp-policy, else 2); use 4 for like-for-like "
                         "comparison with the policy eval, whose policy "
                         "was trained at 4")
    ap.add_argument("--iterations", type=int, default=1,
                    help="sqp-policy: Gauss-Newton iterations per tick")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the resets (and seed+1 the MPPI noise)")
    ap.add_argument("--plain-engine", action="store_true",
                    help="step the plain PyTorch engine instead of the CUDA "
                         "substep kernel (to tell the kernel from the rest "
                         "of the port)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain engine")
    args = ap.parse_args(argv)
    if not args.substeps:
        args.substeps = 4 if args.solver == "sqp-policy" else 2
    if args.solver == "sqp-policy":
        return eval_sqp_policy(num_envs=args.num_envs, steps=args.steps,
                               horizon=args.horizon, substeps=args.substeps,
                               warm_reg=args.warm_reg,
                               iterations=args.iterations,
                               balance_weight=args.balance_weight,
                               policy_prior=args.policy_prior or
                               "runs/Bez_Kick/Bez_Kick_best.ckpt",
                               seed=args.seed,
                               use_kernel=not args.plain_engine,
                               device=args.device)
    if args.solver in ("mppi", "hybrid"):
        return eval_mppi(num_envs=args.num_envs, steps=args.steps,
                         sigma=args.sigma, temperature=args.temperature,
                         num_samples=args.num_samples, horizon=args.horizon,
                         warm_skill=args.warm_skill,
                         use_sqp=args.solver == "hybrid",
                         policy_prior=args.policy_prior,
                         balance_weight=args.balance_weight,
                         terminal_balance_weight=args.terminal_balance_weight,
                         substeps=args.substeps, elite=args.elite,
                         zero_nominal_sample=args.zero_nominal_sample,
                         recovery_samples=args.recovery_samples,
                         recovery_sigma=args.recovery_sigma,
                         recovery_gate=args.recovery_gate, seed=args.seed,
                         use_kernel=not args.plain_engine,
                         device=args.device)
    return eval_policy(args.checkpoint, num_envs=args.num_envs,
                       steps=args.steps, deterministic=not args.stochastic,
                       seed=args.seed, use_kernel=not args.plain_engine,
                       device=args.device)


if __name__ == "__main__":
    print(json.dumps(main()))
