"""Closed-loop hybrid MPPI + SQP ticks on the kick task: per tick, fresh
sampling noise from the seed, one `HybridSolver.solve` over S envs (the MPPI
stage's S x K rollouts of H control steps, then one Gauss-Newton SQP
iteration that polishes MPPI's nominal: forward-mode linearization, Riccati
backward pass, a line search over the step sizes) and one
`KickTask.step_batch` with the polished first actions, ending synchronized.

The comparison holds the stages apart, each from the program's own recorded
inputs: the reference's MPPI from the tick's env, nominal and noise against
the nominal the program's MPPI handed its SQP (`info["mppi_nominal"]`); the
reference hybrid's SQP stage and hand-off from the env and that same
nominal against the program's accepted steps, first actions, polished
sequence and the nominal it carries to the next tick's MPPI stage; the env
step from the program's actions.  A different accepted step is a near-tie
of the line search that rounding may flip: such solves are counted, and the
actions and sequences of the others compared (the sequences over their
first `judged_steps` steps: later steps ride the feedback gains through
contact, as far apart on rounding alone as the TF32 control; the first
actions only where the reference holds its own to `WELL_POSED` when its
handed nominal moves by `PERTURB`), and the step of each env away from a
contact's activation by `CONTACT_MARGIN` and from a kick threshold.  The
SQP writes NaN on purpose (a sequence with a non-finite action costs NaN;
overflowed Riccati gains once the ball rests), so its stages are compared
by `finite_gap`: the same non-finite value at the same place on both sides
counts as equal, one on one side only as a failure.

Traffic keys: `solves` (S), `warm_ticks`, `check_ticks` (ticks the
comparison samples from the window), `profile_after`, `profile_ticks`,
`judged_steps`, `limits`.  Configuration keys: `substeps`, `horizon`,
`num_samples`, `sigma`, `temperature`, and `sqp` (the `SQPConfig` fields
but `horizon`).  The set-up, the sampling of ticks and the start's check
are the MPPI driver's (`mppi_closed_loop.py`).
"""

from __future__ import annotations

import copy
import math

import torch

from portbench import compare, inputs
from portbench.drivers import mppi_closed_loop

# Floor of the cost's relative gap: a tethered cost sums 32 steps of kick
# reward and may pass near zero.
COST_FLOOR = 1e-2
# A change of rounding size (rad) to the nominal handed the reference's SQP
# stage, and how far it may move the reference's first action (rad) for a
# solve's first action to be judged: in a few solves the Riccati gains
# amplify rounding so far that the reference does not hold its own first
# action to the limit (0.58 rad at 1e-6 in one of a tick's 16 solves).
PERTURB = 1e-6
WELL_POSED = 1e-2
# How near (m) a contact of the step may be to its activation for the env's
# step to be judged: one robot point 1.9e-8 m off the ground at a substep
# moved an env by 0.018 on one side of rounding; positions differ by about
# 1e-7 m after a substep.
CONTACT_MARGIN = 1e-6


def finite_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Each env's largest |a - b| over the leading axis, where a value that
    is not finite equals only the same value at the same place on the other
    side (NaN and NaN, inf and inf: 0) and differs from anything else by
    inf."""
    a, b = a.float(), b.float()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    d = torch.where(torch.isnan(d), torch.full_like(d, math.inf), d)
    d = d.reshape(a.shape[0], -1)
    return d.max(dim=1).values if d.shape[1] else d.sum(dim=1)


def cost_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per solve, |a - b| over the larger of |b| and COST_FLOOR, under
    `finite_gap`'s rule."""
    d = finite_gap(a, b)
    scale = torch.where(torch.isfinite(b), b.abs(), torch.ones_like(b))
    return d / scale.clamp_min(COST_FLOOR)


def contact_margins(task, state, actions, gen_state) -> torch.Tensor:
    """Per env, the least distance (m) of any contact to its activation over
    the input states of the substeps of the reference's step (as
    `compare.ref_step` takes it): there its normal force and damping switch
    on, so a state within rounding of it steps to one side or the other."""
    from portbench.reference.ops import engine
    from portbench.reference.ops.kinematics import ancestor_mask

    gen = compare.generator_at(gen_state, actions.device)
    _, targets = task._pre_physics(state, actions, gen)
    model, scene = task.model, task.scene
    mask = ancestor_mask(model)
    h = scene.dt / scene.substeps
    physics, least = state.physics, None
    for _ in range(task.cfg.control_freq_inv * scene.substeps):
        d = _contact_distance(model, scene, physics)
        least = d if least is None else torch.minimum(least, d)
        physics = engine.substep(model, scene, mask, state.dyn, physics,
                                 targets, h)
    return least


def _contact_distance(model, scene, physics) -> torch.Tensor:
    """Per env, the least |penetration| of the robot's contact points on the
    ground, the ball on the ground and the ball on each collision box (the
    reference's `ops/contact.py` geometry)."""
    from portbench.reference.ops.kinematics import (forward_kinematics,
                                                    model_const)

    frames = forward_kinematics(model, physics.q, physics.base_pos,
                                physics.base_quat)
    like = frames.pos
    cb = model_const(model, "cpoint_body", like).long()
    p = frames.pos[..., cb, :] + torch.einsum(
        "...cij,cj->...ci", frames.rot[..., cb, :, :],
        model_const(model, "cpoint_pos", like))
    d = p[..., 2].abs().min(dim=-1).values
    if not scene.has_ball:
        return d
    r, ball = scene.ball_radius, physics.ball_pos
    d = torch.minimum(d, (ball[..., 2] - r).abs())
    bb = model_const(model, "box_body", like).long()
    rb = frames.rot[..., bb, :, :]
    box_c = frames.pos[..., bb, :] + torch.einsum(
        "...kij,kj->...ki", rb, model_const(model, "box_pos", like))
    rbox = torch.einsum("...kij,kjl->...kil", rb,
                        model_const(model, "box_rot", like))
    half = model_const(model, "box_half", like)
    bp = ball[..., None, :]
    local = torch.einsum("...kji,...kj->...ki", rbox, bp - box_c)
    closest = box_c + torch.einsum(
        "...kij,...kj->...ki", rbox,
        torch.maximum(torch.minimum(local, half), -half))
    dist = torch.sqrt(torch.sum((bp - closest) ** 2, dim=-1) + 1e-12)
    return torch.minimum(d, (dist - r).abs().min(dim=-1).values)


class _Handed:
    """An MPPI stage that hands on a given state: the reference hybrid then
    runs its SQP stage and its hand-off from the program's MPPI output."""

    def __init__(self, state, info: dict):
        self.state, self.info = state, info

    def solve(self, env_states, state, gen=None, noise=None):
        return self.state.nominal[:, 0], self.state, self.info


class Cell(mppi_closed_loop.Cell):
    def _configs(self, mppi_cls, sqp_cls):
        c = self.config
        sqp = {**c["sqp"], "line_search": tuple(c["sqp"]["line_search"])}
        return self._mppi_config(mppi_cls), sqp_cls(horizon=c["horizon"],
                                                    **sqp)

    def setup(self) -> None:
        from bez_isaacgym_tpu_torch.solvers.hybrid import HybridSolver
        from bez_isaacgym_tpu_torch.solvers.mppi import MPPIConfig
        from bez_isaacgym_tpu_torch.solvers.sqp import SQPConfig
        from bez_isaacgym_tpu_torch.tasks.base import TaskConfig
        from bez_isaacgym_tpu_torch.tasks.kick import KickTask

        dev = self.device
        self.task = KickTask(TaskConfig(substeps=self.config["substeps"]),
                             device=dev)
        self.solver = HybridSolver(self.task,
                                   *self._configs(MPPIConfig, SQPConfig))
        self.gen = inputs.generator(self.seed, "reset", dev)
        self.noise_gen = inputs.generator(self.seed, "mppi_noise", dev)
        self.env = self.task.reset(self.gen, self.S)
        self.start = compare.snapshot(self.env)
        self.state = self.solver.init_state(self.S)
        self.noise_shape = (self.S, self.config["num_samples"],
                            self.config["horizon"], self.task.num_actions)
        self.sampler = None
        for _ in range(self.traffic["warm_ticks"]):
            info = self._tick(None)
        if "mppi_nominal" not in info:
            raise RuntimeError(
                "HybridSolver.solve returns no info['mppi_nominal'], the "
                "nominal its MPPI stage handed the SQP; the comparison "
                "needs it to hold the two stages apart")
        self.sampler = inputs.Sampler(self.traffic["check_ticks"], self.seed)

    def _tick(self, slot) -> dict:
        noise = torch.randn(self.noise_shape, generator=self.noise_gen,
                            device=self.device)
        rec = None if slot is None else compare.snapshot({
            "env": self.env, "nominal": self.state.mppi.nominal,
            "noise": noise, "gen_state": self.gen.get_state()})
        actions, state, info = self.solver.solve(self.env, self.state,
                                                 noise=noise)
        out = self.task.step_batch(self.env, actions, self.gen)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        if rec is not None:
            self.sampler.records[slot] = {**rec, **compare.snapshot({
                "mppi_nominal": info["mppi_nominal"],
                "best": info["best_score"], "mean": info["mean_score"],
                "actions": actions, "sqp_nominal": state.sqp.nominal,
                "carried": state.mppi.nominal, "cost": info["cost"],
                "accepted": info["accepted"], "out": out})}
        self.env, self.state = out.state, state
        return info

    def instrument(self, spans) -> None:
        spans.wrap(self.solver.mppi, "solve", "solve")
        spans.wrap(self.solver.sqp, "solve", "sqp")
        spans.wrap(self.solver.sqp, "_lin_dyn", "sqp_linearize")
        spans.wrap(self.solver.sqp, "_bf_pass", "sqp_bf_pass")

    def substep_envs_per_tick(self) -> int:
        """Env-substeps the kernel runs per tick, each `substeps` times: the
        MPPI rollouts' S K H control steps; the SQP's nominal rollout, S H;
        each iteration's line search, S H per step size; the env step's
        S."""
        c = self.config
        n_a = len(c["sqp"]["line_search"])
        return c["substeps"] * self.S * (
            c["num_samples"] * c["horizon"] + c["horizon"]
            + c["sqp"]["iterations"] * n_a * c["horizon"] + 1)

    def free(self) -> None:
        self.env = self.state = self.solver = self.task = None

    # ------------------------------------------------------------ the check
    def _reference(self):
        from portbench.reference.solvers.hybrid import HybridSolver
        from portbench.reference.solvers.mppi import MPPIConfig
        from portbench.reference.solvers.sqp import SQPConfig
        from portbench.reference.tasks.base import TaskConfig
        from portbench.reference.tasks.kick import KickTask

        task = KickTask(TaskConfig(substeps=self.config["substeps"]),
                        device=self.device)
        return task, HybridSolver(task, *self._configs(MPPIConfig, SQPConfig))

    def _stages(self, ref, rec: dict, tf32: bool, sqp_from=None):
        """The reference's MPPI stage from the record's env, nominal and
        noise, then the reference hybrid's SQP stage and hand-off from the
        env and `sqp_from` (its own MPPI nominal where None)."""
        from portbench.reference.solvers.mppi import MPPIState

        _, hybrid = ref
        env = compare.env_state(rec["env"])
        with compare.precision(tf32):
            _, m, minfo = hybrid.mppi.solve(env, MPPIState(rec["nominal"]),
                                            noise=rec["noise"])
        handed = m.nominal if sqp_from is None else sqp_from
        return {"mppi_nominal": m.nominal, "best": minfo["best_score"],
                "mean": minfo["mean_score"],
                **self._sqp_stage(ref, env, handed, minfo, tf32)}

    def _sqp_stage(self, ref, env, nominal, minfo: dict, tf32: bool):
        """The reference hybrid's SQP stage and hand-off from `env` and the
        (S, H, nu) nominal its MPPI stage is taken to have handed on."""
        from portbench.reference.solvers.hybrid import HybridState
        from portbench.reference.solvers.mppi import MPPIState
        from portbench.reference.solvers.sqp import SQPState

        _, hybrid = ref
        handed = MPPIState(nominal)
        after = copy.copy(hybrid)
        after.mppi = _Handed(handed, minfo)
        with compare.precision(tf32):
            a, state, info = after.solve(
                env, HybridState(handed, SQPState(nominal)))
        return {"actions": a, "sqp_nominal": state.sqp.nominal,
                "carried": state.mppi.nominal, "cost": info["cost"],
                "accepted": info["accepted"]}

    def control(self, rec: dict, ref) -> dict:
        """The record's outputs as the reference computes them in TF32."""
        task, _ = ref
        out = self._stages(ref, rec, tf32=True)
        step, _ = compare.ref_step(task, compare.env_state(rec["env"]),
                                   out["actions"], rec["gen_state"],
                                   tf32=True)
        return {**rec, **out, "out": step}

    def judge(self, rec: dict, ref) -> dict:
        """Gaps of a tick's outputs against the reference's, stage by stage
        from the same inputs: MPPI (the nominal handed the SQP, the best
        and mean rollout scores), the SQP and the hand-off from the
        program's MPPI nominal (the count of solves whose accepted step
        differs, and of those that the program left unimproved; of the
        others the first actions where well-posed, the polished sequence
        and the nominal carried to the next MPPI stage; the cost, read),
        then the env step from the program's actions."""
        task, _ = ref
        env = compare.env_state(rec["env"])
        r = self._stages(ref, rec, tf32=False, sqp_from=rec["mppi_nominal"])
        # The reference again, its handed nominal moved by rounding size:
        # where that changes its step or moves its first action past
        # WELL_POSED, float32 does not determine the first action, and it
        # is not judged (the solve is counted).
        nominal = rec["mppi_nominal"]
        moved = nominal + PERTURB * torch.randn(
            nominal.shape, device=nominal.device,
            generator=inputs.generator(self.seed, "well_posed",
                                       nominal.device))
        p = self._sqp_stage(ref, env, moved, {}, tf32=False)
        well_posed = (p["accepted"] == r["accepted"]) & (
            finite_gap(p["actions"], r["actions"]) <= WELL_POSED)
        score = torch.maximum(finite_gap(rec["best"], r["best"]),
                              finite_gap(rec["mean"], r["mean"]))
        same_step = rec["accepted"] == r["accepted"]
        n = self.traffic["judged_steps"]
        gaps = {**compare.gaps_of("nominal_gap", finite_gap(
                    rec["mppi_nominal"], r["mppi_nominal"])),
                **compare.gaps_of("score_gap", score),
                "accept_gap_over": float((~same_step).sum()),
                # Of the solves whose step differs, those that the
                # reference's line search improved and the program's left
                # as they came: a near-tie rarely falls that way, a solve
                # whose SQP stage was skipped always does.
                "missed_step_over": float(((r["accepted"] >= 0)
                                           & (rec["accepted"] < 0)).sum()),
                # Read, not judged: the cost sums 32 steps that the feedback
                # gains and contact move apart; solves whose line search
                # took a step.
                **compare.gaps_of("cost_gap", cost_gap(rec["cost"],
                                                       r["cost"])),
                "accepted_steps": float((r["accepted"] >= 0).sum()),
                # Read: solves whose first action is not judged for want
                # of a well-posed reference.
                "ill_posed": float((~well_posed).sum())}
        # Where the accepted steps differ, a near-tie in the line search
        # moves a first action by up to 4.5 rad on rounding alone: those
        # solves are counted above, the others compared here (and every
        # one whose gap is not finite).
        for name, d, keep in (
                ("action_gap", finite_gap(rec["actions"], r["actions"]),
                 same_step & well_posed),
                ("sqp_nominal_gap", finite_gap(rec["sqp_nominal"][:, :n],
                                               r["sqp_nominal"][:, :n]),
                 same_step),
                ("carried_gap", finite_gap(rec["carried"][:, :n],
                                           r["carried"][:, :n]),
                 same_step)):
            gaps.update(compare.gaps_of(name, d, keep | ~torch.isfinite(d)))
        ref_out, margins = compare.ref_step(task, env, rec["actions"],
                                            rec["gen_state"], tf32=False)
        # An env with a contact within CONTACT_MARGIN of its activation is
        # left out of the step's gaps and counted (`borderline`), as one
        # near a kick threshold is.
        near = contact_margins(task, env, rec["actions"],
                               rec["gen_state"]) < CONTACT_MARGIN
        margins = torch.where(near, torch.zeros_like(margins), margins)
        gaps.update(compare.step_gaps(ref_out, margins, rec["out"]))
        return gaps
