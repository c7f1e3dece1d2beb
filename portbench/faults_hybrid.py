"""Faults planted in the hybrid solver's SQP stage and its hand-off, for the checks that
`correct` comes out false in `kick_hybrid.sqp_s16`: each takes
`patch(obj, name, value)` (`setattr`, or pytest's `monkeypatch.setattr`) and
breaks one thing underneath a run.

`portbench/tests/test_portbench_hybrid.py` runs them on the CPU at a tiny
size; on the card they are read at the cell's own size through
`calibrate.readings` with the fault planted first.
"""

import torch

from bez_isaacgym_tpu_torch.solvers import sqp
from bez_isaacgym_tpu_torch.solvers.hybrid import HybridSolver
from bez_isaacgym_tpu_torch.solvers.mppi import MPPIState
from bez_isaacgym_tpu_torch.solvers.riccati import sequential_backward
from bez_isaacgym_tpu_torch.solvers.sqp import (SQPSolver, SQPState,
                                                flatten_physics)


def sqp_skipped(patch):
    """The SQP stage skipped: the MPPI nominal's first action executed, the
    nominal shifted and its own rollout cost reported, no step accepted."""

    def fault(self, env_states, sqp_states, gen=None):
        U = sqp_states.nominal
        accepted = torch.full((U.shape[0],), -1, dtype=torch.long,
                              device=U.device)
        shifted = torch.cat([U[:, 1:], U[:, -1:]], dim=1)
        return U[:, 0], SQPState(nominal=shifted), {
            "cost": self._rollout_cost(env_states, U), "accepted": accepted}

    patch(SQPSolver, "solve", fault)


def sqp_half_skipped(patch):
    """The SQP stage skipped for the first half of the envs, as
    `sqp_skipped` skips it for all."""
    solve = SQPSolver.solve

    def fault(self, env_states, sqp_states, gen=None):
        actions, state, info = solve(self, env_states, sqp_states, gen)
        U = sqp_states.nominal
        h = U.shape[0] // 2
        actions, nominal = actions.clone(), state.nominal.clone()
        cost, accepted = info["cost"].clone(), info["accepted"].clone()
        actions[:h] = U[:h, 0]
        nominal[:h] = torch.cat([U[:h, 1:], U[:h, -1:]], dim=1)
        cost[:h] = self._rollout_cost(env_states, U)[:h]
        accepted[:h] = -1
        return actions, SQPState(nominal=nominal), {"cost": cost,
                                                    "accepted": accepted}

    patch(SQPSolver, "solve", fault)


def line_search_full_step(patch):
    """The line search forced to its full step: every solve takes the step
    of size 1 from the Riccati gains, whether or not it lowers the cost."""

    def fault(self, env, env_ls, U, xs, base_cost, U_ws, A, Bm, cx, cu):
        cfg = self.cfg
        ks, Ks = sequential_backward(A, Bm, cx, cu, cfg.reg + cfg.warm_reg)
        x = flatten_physics(env.physics)
        us, xcs, cost = [], [], 0.0
        for t in range(U.shape[1]):
            u = (U[:, t] + ks[:, t] + (Ks[:, t] @ (x - xs[:, t])[..., None])
                 [..., 0]).clamp(-cfg.u_clip, cfg.u_clip)
            x2 = self._f(env, x, u)
            us.append(u)
            xcs.append(x)
            cost = cost + self._cost(env, x2, u)
            x = x2
        accepted = torch.zeros(U.shape[0], dtype=torch.long, device=U.device)
        return (torch.stack(us, dim=1), torch.stack(xcs, dim=1), cost, cost,
                accepted)

    patch(SQPSolver, "_bf_pass", fault)


def feedback_gains_zeroed(patch):
    """The Riccati pass's feedback gains zeroed: the line search runs open
    loop, each step size adding only its share of the feedforward term."""

    def fault(*a, **k):
        ks, Ks = sequential_backward(*a, **k)
        return ks, torch.zeros_like(Ks)

    patch(sqp, "sequential_backward", fault)


def control_jacobian_zeroed(patch):
    """The linearization's control Jacobian B zeroed."""
    linearize = SQPSolver.linearize_dynamics

    def fault(self, *a, **k):
        A, B = linearize(self, *a, **k)
        return A, torch.zeros_like(B)

    patch(SQPSolver, "linearize_dynamics", fault)


def sqp_one_env_altered(patch):
    """A fault confined to one env: the last env's SQP action altered by
    0.2 rad."""
    solve = SQPSolver.solve

    def fault(self, *a, **k):
        actions, state, info = solve(self, *a, **k)
        actions = actions.clone()
        actions[-1] += 0.2
        return actions, state, info

    patch(SQPSolver, "solve", fault)


def carried_mppi_own(patch):
    """The hybrid hands the next tick's MPPI stage the nominal its MPPI
    stage made, not the SQP's polished sequence."""
    solve = HybridSolver.solve

    def fault(self, *a, **k):
        actions, state, info = solve(self, *a, **k)
        return actions, state._replace(
            mppi=MPPIState(nominal=info["mppi_nominal"])), info

    patch(HybridSolver, "solve", fault)


def carried_unchanged(patch):
    """The hybrid leaves the MPPI stage's nominal as it came in."""
    solve = HybridSolver.solve

    def fault(self, env_states, state, *a, **k):
        actions, new, info = solve(self, env_states, state, *a, **k)
        return actions, new._replace(mppi=state.mppi), info

    patch(HybridSolver, "solve", fault)


FAULTS = {
    "kick_hybrid.sqp_s16": [sqp_skipped, sqp_half_skipped,
                            line_search_full_step, feedback_gains_zeroed,
                            control_jacobian_zeroed, sqp_one_env_altered,
                            carried_mppi_own, carried_unchanged],
}
