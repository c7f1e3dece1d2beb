"""The comparison that decides a run's `correct`.

The reference (`portbench/reference/`) follows the program step by step from
the program's own recorded inputs: the same env states, actions, noise,
permutations and generator states the window fed the port.  What the port
produced is judged against what the reference computes from those inputs.
The control is the reference itself in the program's place, computed with
TF32 matmuls (the precision next below the configurations' float32 with
TF32 off); `precision(tf32=...)` sets that around every reference call.

A gap is a largest absolute difference, or a relative one where the name
says so.  Where contact or a softmax makes a few envs' outcomes chaotic (a
contact that activates on one side of rounding and not the other, a rollout
that falls on one side), the gap over a batch is the 90th percentile over
its envs of each env's largest difference (`Q`).  Beside it stand the
largest (`..._max`) and, for a step, the count of envs over a looser bound
(`..._over`, `LOOSE`), so that a fault confined to a few envs shows too.
Each compared reading has its limit in the cell's traffic file (`limits`),
set in `PERF.md` from the program's and the control's readings.
"""

from __future__ import annotations

import contextlib
import math

import torch

# Kick task thresholds (tasks/kick.py::reward_done) a state can sit on: an
# env whose reference state lies within MARGIN of one of them may take the
# other branch on rounding alone, so its step is left out of the gaps (and
# counted as `borderline`).
MARGIN = 1e-3
# The obs columns that are continuous in the state: 8 foot-sensor columns
# (44:52) are +-1 patterns of force components against 0.01 N, which flip on
# rounding, and are left out.
OBS_CONTINUOUS = list(range(0, 44)) + [52, 53]
# The quantile over envs that a batch's gap reads.
Q = 0.9
# Per step gap, the bound an env's gap is counted over (`..._over`).
LOOSE = {"physics_gap": 1e-2, "obs_gap": 1e-2, "reward_gap": 2e-5}
PHYSICS_FIELDS = ("q", "qd", "base_pos", "base_quat", "base_u", "ball_pos",
                  "ball_quat", "ball_vel", "ball_ang")


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 matmuls on (the control) or off (the reference) inside."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def max_abs(a: torch.Tensor, b: torch.Tensor, keep=None) -> float:
    """Largest |a - b| (over the envs in `keep`, a bool mask of the leading
    axis); inf where either side is not finite."""
    a, b = a.float(), b.float()
    if keep is not None:
        a, b = a[keep], b[keep]
    if a.numel() == 0:
        return 0.0
    d = (a - b).abs()
    if not bool(torch.isfinite(a).all() and torch.isfinite(b).all()):
        return math.inf
    return float(d.max())


def per_env(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Each env's largest |a - b| (inf where not finite), over the leading
    axis."""
    d = (a.float() - b.float()).abs().reshape(a.shape[0], -1)
    d = torch.where(torch.isfinite(d), d, torch.full_like(d, math.inf))
    return d.max(dim=1).values if d.shape[1] else d.sum(dim=1)


def batch_gap(d: torch.Tensor, keep=None) -> tuple[float, float]:
    """(Q-quantile, largest) of per-env gaps `d` over the envs in `keep`."""
    if keep is not None:
        d = d[keep]
    if d.numel() == 0:
        return 0.0, 0.0
    if not bool(torch.isfinite(d).all()):
        return math.inf, math.inf
    return float(torch.quantile(d, Q)), float(d.max())


def gaps_of(name: str, d: torch.Tensor, keep=None) -> dict:
    q, m = batch_gap(d, keep)
    out = {name: q, f"{name}_max": m}
    if name in LOOSE:
        k = d if keep is None else d[keep]
        out[f"{name}_over"] = float((~(k <= LOOSE[name])).sum())
    return out


def snapshot(x):
    """A copy of every tensor in `x` (nested NamedTuples, tuples, lists and
    dicts), so that a record keeps what the program produced even where the
    program later reuses its buffers."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: snapshot(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        out = [snapshot(v) for v in x]
        if hasattr(x, "_fields"):
            return type(x)(*out)
        return type(x)(out)
    return x


def env_state(x):
    """The port's EnvState as the reference's (same fields, by name)."""
    from portbench.reference.models.robot import DynParams
    from portbench.reference.ops.engine import PhysicsState
    from portbench.reference.tasks.base import EnvState

    d = x._asdict()
    d["physics"] = PhysicsState(**x.physics._asdict())
    d["dyn"] = DynParams(**x.dyn._asdict())
    return EnvState(**d)


def generator_at(state: torch.Tensor, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


def kick_margins(task, state, physics) -> torch.Tensor:
    """Per env, the least distance of the stepped state to one of the kick
    task's termination and reward-branch thresholds (m or rad)."""
    bez_xy = physics.base_pos[:, :2]
    ball_xy = physics.ball_pos[:, :2]
    init_xy = torch.as_tensor(task.cfg.bez_init_pos[:2], device=bez_xy.device)
    to_goal = state.goal - ball_xy
    to_goal_n = torch.linalg.norm(to_goal, dim=-1)
    u = to_goal / to_goal_n.clamp_min(1e-9)[:, None]
    init = state.goal - state.ball_init
    init = init / torch.linalg.norm(init, dim=-1).clamp_min(1e-9)[:, None]
    angle = torch.abs(torch.atan2(init[:, 1], init[:, 0])
                      - torch.atan2(u[:, 1], u[:, 0]))
    return torch.stack([
        torch.abs(physics.base_pos[:, 2] - 0.275),
        torch.abs(torch.linalg.norm(bez_xy - init_xy, dim=-1) - 0.5),
        torch.abs(angle - 1.5708),
        torch.abs(to_goal_n - 0.05),
        torch.abs(torch.linalg.norm(ball_xy - state.ball_init, dim=-1) - 0.3),
    ]).min(dim=0).values


def ref_step(task, state, actions, gen_state, tf32: bool):
    """The reference's env step (`BezTask.step_batch`, phase by phase) from
    `state` with `actions`, its resets drawn from a generator at
    `gen_state`.  Returns (StepOutput, margins)."""
    gen = generator_at(gen_state, actions.device)
    with precision(tf32):
        acts, targets = task._pre_physics(state, actions, gen)
        physics = state.physics
        for _ in range(task.cfg.control_freq_inv):
            physics = task._step_physics_batch(state.dyn, physics, targets)
        margins = kick_margins(task, state, physics)
        return task._post_physics(state, physics, acts, gen), margins


def step_gaps(ref_out, margins, out) -> dict:
    """Gaps of a step's output `out` against the reference's, over the envs
    away from every threshold."""
    keep = margins >= MARGIN
    ph, rph = out.state.physics, ref_out.state.physics
    cols = torch.as_tensor(OBS_CONTINUOUS, device=out.obs.device)
    physics = torch.stack([per_env(getattr(ph, f), getattr(rph, f))
                           for f in PHYSICS_FIELDS]).max(dim=0).values
    force = torch.maximum(
        per_env(ph.body_contact_force, rph.body_contact_force),
        per_env(ph.sensor_normal, rph.sensor_normal))
    return {**gaps_of("physics_gap", physics, keep),
            **gaps_of("force_gap", force, keep),
            **gaps_of("obs_gap", per_env(out.obs[:, cols],
                                         ref_out.obs[:, cols]), keep),
            **gaps_of("reward_gap", per_env(out.reward, ref_out.reward),
                      keep),
            "borderline": float((~keep).sum())}


def worst(rows: list[dict]) -> dict:
    """Per key, the largest reading over the records (counts add up)."""
    out: dict = {}
    for r in rows:
        for k, v in r.items():
            out[k] = out.get(k, 0.0) + v if k == "borderline" \
                else max(out.get(k, -math.inf), v)
    return out


def judge(gaps: dict, limits: dict) -> list[tuple[str, float, float]]:
    """(name, reading, limit) of each compared gap, in the limits' order."""
    return [(k, gaps.get(k, math.inf), lim) for k, lim in limits.items()]


def passed(checks) -> bool:
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks)
