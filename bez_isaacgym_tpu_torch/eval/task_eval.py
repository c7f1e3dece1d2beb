"""Closed-loop policy evals for the goalie, orient and walk tasks.

Port of `bez_isaacgym_tpu/eval/task_eval.py`:
  - goalie: block rate against the -10 m/s shot (an episode is conceded
    when the ball passes the robot, goalie_env.py:625-632);
  - orient: final heading error, final height and up-projection;
  - walk: goal reach, the task's own win state, falls.

The physics runs through the CUDA substep kernel on the card.  Per-env
tallies of each env's first episode stay on the device; the host reads one
flag per step, to stop once every env has finished.  The walk eval also
takes a recurrent (LSTM) checkpoint (`--rnn-units`, `--seq-len`): the
policy is recurrent PPO's `act` with a per-env carry zeroed on done.

Usage:
    python -m bez_isaacgym_tpu_torch.eval.task_eval --task goalie \\
        --checkpoint runs/Bez_Goalie/Bez_Goalie_best.ckpt
    python -m bez_isaacgym_tpu_torch.eval.task_eval --task orient \\
        --checkpoint runs/Bez_Orient/Bez_Orient_best.ckpt
    python -m bez_isaacgym_tpu_torch.eval.task_eval --task walk \\
        --checkpoint runs/Bez_Walk/Bez_Walk_best.ckpt
    python -m bez_isaacgym_tpu_torch.eval.task_eval --task walk \\
        --checkpoint <an LSTM walk checkpoint> --rnn-units 128 --seq-len 4
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math

import numpy as np
import torch

from bez_isaacgym_tpu_torch import resolve_device
from bez_isaacgym_tpu_torch.ops.quat import quat_axis
from bez_isaacgym_tpu_torch.tasks.base import BezTask, StepOutput

def _policy(task: BezTask, checkpoint: str, num_envs: int,
            rnn_units: int, seq_len: int):
    """(act, on_done): deterministic actions from a checkpoint, and the
    hook that zeroes a recurrent policy's carry where an episode ended."""
    if rnn_units <= 0:
        from bez_isaacgym_tpu_torch.rl.players import PpoPlayerContinuous

        player = PpoPlayerContinuous(task, checkpoint_path=checkpoint,
                                     device=task.device)
        return (lambda obs: player.get_action(obs, True)), (lambda d: None)
    from bez_isaacgym_tpu_torch import convert
    from bez_isaacgym_tpu_torch.rl.ppo import PPOConfig
    from bez_isaacgym_tpu_torch.rl.ppo_rnn import PPORNN, zero_done
    from bez_isaacgym_tpu_torch.utils.checkpoint import read_msgpack

    ppo = PPORNN(task, num_envs, PPOConfig(rnn_units=rnn_units,
                                           seq_len=seq_len, horizon=seq_len))
    ts = ppo.check(convert.train_state(read_msgpack(checkpoint)))
    carry = [ppo.initial_carry()]

    def act(obs):
        a, carry[0] = ppo.act(ts, obs, carry[0])
        return a

    def on_done(done):
        carry[0] = zero_done(carry[0], done)

    return act, on_done


def _rollout(task: BezTask, checkpoint: str, num_envs: int, steps: int,
             seed: int, on_step, rnn_units: int = 0, seq_len: int = 4):
    """Shared closed-loop policy loop; `on_step(out, live)` folds one step
    into the caller's device tallies.  rnn_units > 0 runs a recurrent
    (LSTM) checkpoint, its per-env carry zeroed on done (runner.play's
    recurrent path).  Returns the final state."""
    dev = task.device
    act, on_done = _policy(task, checkpoint, num_envs, rnn_units, seq_len)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = task.reset(gen, num_envs)
    # The first obs observes the reset states (no zero-action step).
    zero = torch.zeros((num_envs, task.num_actions), dtype=torch.float32,
                       device=dev)
    obs, state = task.observe(state, zero)
    finished = torch.zeros(num_envs, dtype=torch.bool, device=dev)
    for _ in range(steps):
        out: StepOutput = task.step_batch(state, act(obs), gen)
        on_step(out, ~finished)
        finished |= out.done
        on_done(out.done)
        state, obs = out.state, out.obs
        if bool(finished.all()):
            break
    return state


def _np(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def eval_goalie(checkpoint: str, num_envs: int = 64, steps: int = 1500,
                seed: int = 0, use_kernel: bool = True, device="cuda"):
    """Block rate against the -10 m/s shot.

    conceded  = ball passed the robot (the reference's -10000 reset,
                goalie_env.py:625-632)
    blocked   = episode ended (ball stopped / horizon) without conceding
    cleared   = blocked AND the ball was sent back past x >= 1.0 m
    use_kernel=False steps the plain engine on the card too.
    """
    from bez_isaacgym_tpu_torch.tasks.goalie import GoalieTask, goalie_config

    dev = resolve_device(device)
    task = GoalieTask(dataclasses.replace(goalie_config(),
                                          use_kernel=use_kernel), device=dev)
    t = {k: torch.zeros(num_envs, dtype=torch.bool, device=dev)
         for k in ("conceded", "blocked", "cleared", "fell")}
    min_ball_x = torch.full((num_envs,), math.inf, device=dev)

    def on_step(out, live):
        ph = out.state.physics
        ball_x, bez_x = ph.ball_pos[:, 0], ph.base_pos[:, 0]
        torch.minimum(min_ball_x, torch.where(live, ball_x, math.inf),
                      out=min_ball_x)
        d = out.done & live
        passed = ball_x < bez_x
        t["conceded"] |= d & passed
        t["blocked"] |= d & ~passed
        t["cleared"] |= d & ~passed & (ball_x >= 1.0)
        t["fell"] |= d & (ph.base_pos[:, 2] < 0.2)  # goalie stands at 0.29

    _rollout(task, checkpoint, num_envs, steps, seed, on_step)
    r = {k: float(v.float().mean()) for k, v in t.items()}
    mbx = _np(min_ball_x)
    return {
        "num_envs": num_envs,
        "shot_speed_mps": 10.0,
        "block_rate": r["blocked"],
        "conceded_rate": r["conceded"],
        "clear_rate": r["cleared"],
        "fall_rate": r["fell"],
        "mean_min_ball_x_m": float(mbx[np.isfinite(mbx)].mean()),
        "note": "blocked = episode ended without the ball passing the robot "
                "(goalie_env.py:625-632 conceded reset); cleared = blocked "
                "and ball returned past x>=1 m.",
    }


def eval_orient(checkpoint: str, num_envs: int = 64, steps: int = 600,
                seed: int = 0, use_kernel: bool = True, device="cuda"):
    """Final heading error + final posture (height, up-projection)."""
    from bez_isaacgym_tpu_torch.tasks.orient import (OrientTask,
                                                     compute_off_angle,
                                                     orient_config)

    dev = resolve_device(device)
    task = OrientTask(dataclasses.replace(orient_config(),
                                          use_kernel=use_kernel), device=dev)
    final = {k: torch.full((num_envs,), math.nan, device=dev)
             for k in ("err", "height", "up")}

    def on_step(out, live):
        ph = out.state.physics
        _, ang = compute_off_angle(ph.base_quat, out.state.goal_angle)
        d = out.done & live
        for k, v in (("err", ang.abs()), ("height", ph.base_pos[:, 2]),
                     ("up", quat_axis(ph.base_quat, 2)[:, 2])):
            final[k] = torch.where(d, v, final[k])

    _rollout(task, checkpoint, num_envs, steps, seed, on_step)
    err, height, up = (_np(final[k]) for k in ("err", "height", "up"))
    ok = ~np.isnan(err)
    return {
        "num_envs": num_envs,
        "episodes_finished": int(ok.sum()),
        "mean_final_angle_err_rad": float(np.nanmean(err)),
        "median_final_angle_err_rad": float(np.nanmedian(err)),
        "within_0.2rad": float((err[ok] < 0.2).mean()),
        "mean_final_height_m": float(np.nanmean(height)),
        "mean_final_up_proj": float(np.nanmean(up)),
        "upright_rate": float((up[ok] > 0.7).mean()),
        "note": "posture fields quantify the orient policy's "
                "height-for-heading tradeoff (round-2 STATUS).",
    }


def eval_walk(checkpoint: str, num_envs: int = 64, steps: int = 600,
              seed: int = 0, goal_range: float = 2.0,
              goal_range_min: float = 0.0, rnn_units: int = 0,
              seq_len: int = 4, use_kernel: bool = True, device="cuda"):
    """Goal-reach stats for the walk task (goal uniform in [-2,2]^2).

    win        = the task's own 4-condition win state fired (near goal +
                 near default pose + low ang/lin vel, walk_env.py:943-965)
    reached    = closest approach to the goal < 0.25 m
    final_dist = distance to goal when the episode ended
    rnn_units > 0 evaluates an LSTM checkpoint (seq_len as trained).
    """
    from bez_isaacgym_tpu_torch.tasks.walk import WalkTask, walk_config

    dev = resolve_device(device)
    task = WalkTask(dataclasses.replace(
        walk_config(), goal_range=goal_range, goal_range_min=goal_range_min,
        use_kernel=use_kernel), device=dev)
    min_dist = torch.full((num_envs,), math.inf, device=dev)
    final = {k: torch.full((num_envs,), math.nan, device=dev)
             for k in ("dist", "height")}
    flag = {k: torch.zeros(num_envs, dtype=torch.bool, device=dev)
            for k in ("fell", "won")}

    def on_step(out, live):
        ph = out.state.physics
        dist = torch.linalg.norm(out.state.goal - ph.base_pos[:, :2], dim=-1)
        height = ph.base_pos[:, 2]
        torch.minimum(min_dist, torch.where(live, dist, math.inf),
                      out=min_dist)
        # Win = the task's own 4-condition predicate recomputed on the
        # post-step state (walk_env.py:943-965), not a reward threshold.
        pos_err = torch.linalg.norm(ph.q - task.default_dof_pos, dim=-1)
        vel_lin = torch.linalg.norm(ph.base_u[:, 0:3], dim=-1)
        vel_ang = torch.linalg.norm(ph.base_u[:, 3:6], dim=-1)
        w = (dist < 0.05) & (pos_err < 0.15) & (vel_ang < 0.1) \
            & (vel_lin < 0.1)
        flag["won"] |= live & w
        d = out.done & live
        final["dist"] = torch.where(d, dist, final["dist"])
        final["height"] = torch.where(d, height, final["height"])
        flag["fell"] |= d & (height < 0.275)

    _rollout(task, checkpoint, num_envs, steps, seed, on_step,
             rnn_units=rnn_units, seq_len=seq_len)
    md, fd, fh = _np(min_dist), _np(final["dist"]), _np(final["height"])
    ok = ~np.isnan(fd)
    return {
        "num_envs": num_envs,
        "goal_range": goal_range,
        "goal_range_min": goal_range_min,
        "rnn_units": rnn_units,
        "episodes_finished": int(ok.sum()),
        "win_rate": float(flag["won"].float().mean()),
        "reach_rate_0.25m": float((md < 0.25).mean()),
        "mean_min_goal_dist_m": float(md[np.isfinite(md)].mean()),
        "mean_final_goal_dist_m": float(np.nanmean(fd)),
        "mean_final_height_m": float(np.nanmean(fh)),
        "fall_rate": float(flag["fell"].float().mean()),
        "note": "goal uniform in the [-goal_range, goal_range]^2 box "
                "(ring r in [goal_range_min, goal_range] when min > 0); "
                "win = the task's 4-condition win state "
                "(walk_env.py:943-965) recomputed from the post-step "
                "state.",
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", choices=["goalie", "orient", "walk"],
                    required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--num-envs", type=int, default=64)
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the resets (and the walk goals)")
    ap.add_argument("--goal-range", type=float, default=2.0,
                    help="walk only: goal box half-width (2.0 = reference)")
    ap.add_argument("--goal-range-min", type=float, default=0.0)
    ap.add_argument("--rnn-units", type=int, default=0,
                    help=">0: evaluate a recurrent (LSTM) checkpoint")
    ap.add_argument("--seq-len", type=int, default=4)
    ap.add_argument("--plain-engine", action="store_true",
                    help="step the plain PyTorch engine instead of the CUDA "
                         "substep kernel (to tell the kernel from the rest "
                         "of the port)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain engine")
    args = ap.parse_args(argv)
    common = dict(seed=args.seed, use_kernel=not args.plain_engine,
                  device=args.device)
    if args.task == "goalie":
        return eval_goalie(args.checkpoint, args.num_envs,
                           args.steps or 1500, **common)
    if args.task == "walk":
        return eval_walk(args.checkpoint, args.num_envs, args.steps or 600,
                         goal_range=args.goal_range,
                         goal_range_min=args.goal_range_min,
                         rnn_units=args.rnn_units, seq_len=args.seq_len,
                         **common)
    return eval_orient(args.checkpoint, args.num_envs, args.steps or 600,
                       **common)


if __name__ == "__main__":
    print(json.dumps(main(), indent=1))
