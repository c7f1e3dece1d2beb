"""The port's hybrid MPPI + SQP solver, stage by stage: `info["mppi_nominal"]`
is the very sequence the MPPI stage handed the SQP stage, and the state the
solve carries to the next tick is the SQP's polished sequence, for each
SQP variant and where the ball rests and the Riccati gains overflow.

Pure torch on the CPU at S=2 solves x K=4 samples x H=3 steps, substeps 1
(2 for the resting ball); the hybrid's JAX parity is `tests/test_torch_hybrid.py`.
"""

import pytest
import torch

from bez_isaacgym_tpu_torch.solvers.hybrid import HybridSolver
from bez_isaacgym_tpu_torch.solvers.mppi import MPPIConfig
from bez_isaacgym_tpu_torch.solvers.riccati import sequential_backward
from bez_isaacgym_tpu_torch.solvers.sqp import SQPConfig
from bez_isaacgym_tpu_torch.tasks.base import TaskConfig
from bez_isaacgym_tpu_torch.tasks.kick import KickTask

torch.set_num_threads(2)

S, K, H, NA = 2, 4, 3, 18
MPPI_KW = dict(horizon=H, num_samples=K, sigma=0.15, temperature=0.05)
SEEDS = [3000000041, 3000000042]
# Resets whose ball has come to rest after 30 control steps.
RESTING_SEED = 3000000031
SQP_VARIANTS = {
    "one_iteration": dict(iterations=1),
    "two_iterations": dict(iterations=2),
    "parallel_riccati": dict(iterations=1, parallel_riccati=True),
    "relinearize_every_2": dict(iterations=2, relinearize_every=2),
    "tethered": dict(iterations=1, warm_reg=0.1),
}


@pytest.fixture(scope="module")
def task():
    return KickTask(TaskConfig(substeps=1), device="cpu")


def start(task, seed):
    """Seeded resets, a seeded nominal and the generator of the noise."""
    env = task.reset(torch.Generator().manual_seed(seed), S)
    g = torch.Generator().manual_seed(seed + 1)
    return env, 0.2 * torch.rand((S, H, NA), generator=g) - 0.1, g


def spy_sqp(solver):
    """Record what the SQP stage is handed and what it returns."""
    seen = {}
    solve = solver.sqp.solve

    def spy(env_states, sqp_states, gen=None):
        seen["nominal"] = sqp_states.nominal
        seen["out"] = solve(env_states, sqp_states, gen)
        return seen["out"]

    solver.sqp.solve = spy
    return seen


def assert_stages_handed_on(solver, env, state, noise):
    """One hybrid solve against its two stages run from the same inputs."""
    seen = spy_sqp(solver)
    actions, new, info = solver.solve(env, state, noise=noise)
    _, m, minfo = solver.mppi.solve(env, state.mppi, noise=noise)
    sqp_actions, sqp_state, sqp_info = seen["out"]
    assert info["mppi_nominal"] is seen["nominal"]
    assert torch.equal(info["mppi_nominal"], m.nominal)
    assert torch.equal(actions, sqp_actions)
    assert new.sqp.nominal is sqp_state.nominal
    assert new.mppi.nominal is sqp_state.nominal
    for k in ("best_score", "mean_score"):
        assert torch.equal(info[k], minfo[k]), k
    for k in ("cost", "accepted"):
        assert info[k] is sqp_info[k], k
    return actions, new


@pytest.mark.parametrize("variant", list(SQP_VARIANTS))
@pytest.mark.parametrize("seed", SEEDS)
def test_mppi_nominal_is_what_the_sqp_stage_polished(task, seed, variant):
    """Two closed-loop ticks: each tick's `mppi_nominal` is the tensor the
    SQP stage got, equal to the MPPI stage's nominal from the same inputs,
    and the next tick starts from the SQP's polished sequence."""
    env, U, g = start(task, seed)
    solver = HybridSolver(task, MPPIConfig(**MPPI_KW), SQPConfig(
        horizon=H, **SQP_VARIANTS[variant]))
    state = solver.warm_start(solver.init_state(S), U)
    gen = torch.Generator().manual_seed(seed + 2)
    for _ in range(2):
        noise = torch.randn((S, K, H, NA), generator=g)
        actions, state = assert_stages_handed_on(solver, env, state, noise)
        env = task.step_batch(env, actions, gen).state


@pytest.mark.parametrize("seed", SEEDS)
def test_mppi_only_solve_hands_back_no_mppi_nominal(task, seed):
    """Without the SQP stage the solve acts on MPPI's nominal, keeps the
    SQP state it was given and adds no key."""
    env, U, g = start(task, seed)
    solver = HybridSolver(task, MPPIConfig(**MPPI_KW),
                          SQPConfig(horizon=H, iterations=1), use_sqp=False)
    state = solver.warm_start(solver.init_state(S), U)
    noise = torch.randn((S, K, H, NA), generator=g)
    actions, new, info = solver.solve(env, state, noise=noise)
    _, m, _ = solver.mppi.solve(env, state.mppi, noise=noise)
    assert "mppi_nominal" not in info
    assert torch.equal(actions, m.nominal[:, 0])
    assert torch.equal(new.mppi.nominal, m.nominal)
    assert new.sqp is state.sqp


def test_stages_handed_on_where_the_gains_overflow():
    """With the ball at rest (substeps 2, after 30 control steps at the
    default joint targets) the Riccati gains overflow and no step is
    accepted: the SQP hands the MPPI nominal on, shifted, and the key is
    still the nominal it got."""
    task = KickTask(TaskConfig(substeps=2), device="cpu")
    env, _, g = start(task, RESTING_SEED)
    ph = env.physics
    targets = task.default_dof_pos.expand(S, -1)
    for _ in range(30):
        ph = task._step_physics_batch(env.dyn, ph, targets)
    assert float(ph.ball_vel.norm(dim=-1).max()) < 0.05
    env = env._replace(physics=ph)
    solver = HybridSolver(task, MPPIConfig(**MPPI_KW),
                          SQPConfig(horizon=H, iterations=1))
    U = torch.zeros((S, H, NA))
    sqp = solver.sqp
    xs, _ = sqp._rollout(env, U)
    A, Bm = sqp._lin_dyn(env, xs, U)
    cx, cu = sqp._cost_grads(env, xs, U, U)
    _, Ks = sequential_backward(A, Bm, cx, cu, sqp.cfg.reg)
    assert not bool(torch.isfinite(Ks).all())

    state = solver.warm_start(solver.init_state(S), U)
    noise = torch.randn((S, K, H, NA), generator=g)
    seen = spy_sqp(solver)
    actions, new, info = solver.solve(env, state, noise=noise)
    M = seen["nominal"]
    assert info["mppi_nominal"] is M
    assert bool((info["accepted"] == -1).all())
    assert torch.equal(actions, M[:, 0])
    assert torch.equal(new.mppi.nominal, torch.cat([M[:, 1:], M[:, -1:]], 1))
