"""The port's SQP and hybrid MPPI + SQP solvers against the benchmark's
frozen plain reference (`portbench/reference/solvers/{sqp,riccati,hybrid}.py`),
on the CPU, where both step the plain engine: the same seeded resets, noise
and nominals give the same actions, nominals, costs and accepted steps.

Where the ball rests on the ground the linearization's rolling-friction
slope overflows the Riccati gains to non-finite values, on both sides alike:
there the two sides are held to the benchmark's rule
(`portbench/drivers/hybrid_closed_loop.py::finite_gap`), under which the
same non-finite value at the same place counts as equal; that rule is
tested here too.  Pure torch; the hybrid's JAX parity is
`tests/test_torch_hybrid.py`.

    python -m pytest portbench/tests -q
"""

import math

import pytest
import torch

from bez_isaacgym_tpu_torch.solvers import riccati as port_riccati
from bez_isaacgym_tpu_torch.solvers.hybrid import HybridSolver
from bez_isaacgym_tpu_torch.solvers.mppi import MPPIConfig
from bez_isaacgym_tpu_torch.solvers.sqp import SQPConfig, SQPSolver, SQPState
from bez_isaacgym_tpu_torch.tasks.base import TaskConfig
from bez_isaacgym_tpu_torch.tasks.kick import KickTask
from portbench import compare
from portbench.drivers.hybrid_closed_loop import cost_gap, finite_gap
from portbench.reference.solvers import hybrid as ref_hybrid
from portbench.reference.solvers import mppi as ref_mppi
from portbench.reference.solvers import riccati as ref_riccati
from portbench.reference.solvers import sqp as ref_sqp
from portbench.reference.tasks import base as ref_base
from portbench.reference.tasks.kick import KickTask as RefKick

torch.set_num_threads(2)

S, K, H, NA = 2, 4, 3, 18
MPPI_KW = dict(horizon=H, num_samples=K, sigma=0.15, temperature=0.05)
SEEDS = [3000000031, 3000000032]


def tasks(substeps):
    return (KickTask(TaskConfig(substeps=substeps), device="cpu"),
            RefKick(ref_base.TaskConfig(substeps=substeps), device="cpu"))


def resets(port, ref, seed):
    """Both tasks' resets from generators at the same seed, and the port's
    generator for later steps."""
    gp = torch.Generator().manual_seed(seed)
    env = port.reset(gp, S)
    ref_env = ref.reset(torch.Generator().manual_seed(seed), S)
    assert torch.equal(env.physics.q, ref_env.physics.q)
    return env, gp


def nominal(seed):
    g = torch.Generator().manual_seed(seed + 1)
    return 0.2 * torch.rand((S, H, NA), generator=g) - 0.1


def assert_sqp_outputs_equal(port_out, ref_out):
    (pa, ps, pi), (ra, rs, ri) = port_out, ref_out
    assert torch.equal(pa, ra)
    assert torch.equal(ps.nominal, rs.nominal)
    assert torch.equal(pi["cost"], ri["cost"])
    assert torch.equal(pi["accepted"], ri["accepted"])


@pytest.mark.parametrize("seed", SEEDS)
def test_sqp_solve_equals_reference(seed):
    port, ref = tasks(1)
    env, _ = resets(port, ref, seed)
    cfg = dict(horizon=H, iterations=1)
    U = nominal(seed)
    out = SQPSolver(port, SQPConfig(**cfg)).solve(env, SQPState(U))
    ref_out = ref_sqp.SQPSolver(ref, ref_sqp.SQPConfig(**cfg)).solve(
        compare.env_state(env), ref_sqp.SQPState(U))
    assert_sqp_outputs_equal(out, ref_out)


@pytest.mark.parametrize("seed", SEEDS)
def test_hybrid_solve_equals_reference(seed):
    """Two closed-loop ticks from a seeded nominal: each tick's actions,
    both stages' nominals, MPPI's scores, the SQP's cost and accepted step,
    and `info["mppi_nominal"]` against the reference MPPI stage's nominal
    from the same inputs."""
    port, ref = tasks(1)
    env, gen = resets(port, ref, seed)
    solver = HybridSolver(port, MPPIConfig(**MPPI_KW), SQPConfig(
        horizon=H, iterations=1))
    rsolver = ref_hybrid.HybridSolver(ref, ref_mppi.MPPIConfig(**MPPI_KW),
                                      ref_sqp.SQPConfig(horizon=H,
                                                        iterations=1))
    U = nominal(seed)
    state = solver.warm_start(solver.init_state(S), U)
    rstate = rsolver.warm_start(rsolver.init_state(S), U)
    ng = torch.Generator().manual_seed(seed + 2)
    for _ in range(2):
        noise = torch.randn((S, K, H, NA), generator=ng)
        renv = compare.env_state(env)
        a, new, info = solver.solve(env, state, noise=noise)
        ra, rnew, rinfo = rsolver.solve(renv, rstate, noise=noise)
        _, rm, _ = rsolver.mppi.solve(renv, rstate.mppi, noise=noise)
        assert torch.equal(info["mppi_nominal"], rm.nominal)
        assert torch.equal(a, ra)
        for stage in ("mppi", "sqp"):
            assert torch.equal(getattr(new, stage).nominal,
                               getattr(rnew, stage).nominal), stage
        for k in ("best_score", "mean_score", "cost", "accepted"):
            assert torch.equal(info[k], rinfo[k]), k
        env, state, rstate = port.step_batch(env, a, gen).state, new, rnew


@pytest.fixture(scope="module")
def resting():
    """Kick envs at substeps 2 after 30 control steps at the default joint
    targets: the ball has landed and rests on the ground."""
    port, ref = tasks(2)
    env, _ = resets(port, ref, SEEDS[0])
    ph = env.physics
    targets = port.default_dof_pos.expand(S, -1)
    for _ in range(30):
        ph = port._step_physics_batch(env.dyn, ph, targets)
    assert float(ph.ball_vel.norm(dim=-1).max()) < 0.05
    return port, ref, env._replace(physics=ph)


def test_ball_at_rest_gains_agree_under_the_nonfinite_rule(resting):
    """The Riccati gains along the resting ball's nominal are not all
    finite, and the port's and the reference's passes agree place by place
    under the rule; the solves then keep their nominal alike."""
    port, ref, env = resting
    U = torch.zeros((S, H, NA))
    solver = SQPSolver(port, SQPConfig(horizon=H, iterations=1))
    xs, _ = solver._rollout(env, U)
    A, Bm = solver._lin_dyn(env, xs, U)
    cx, cu = solver._cost_grads(env, xs, U, U)
    reg = solver.cfg.reg
    ks, Ks = port_riccati.sequential_backward(A, Bm, cx, cu, reg)
    rks, rKs = ref_riccati.sequential_backward(A, Bm, cx, cu, reg)
    assert not bool(torch.isfinite(Ks).all())
    assert not bool(finite_gap(Ks, rKs).any())
    assert not bool(finite_gap(ks, rks).any())

    out = solver.solve(env, SQPState(U))
    ref_out = ref_sqp.SQPSolver(ref, ref_sqp.SQPConfig(
        horizon=H, iterations=1)).solve(compare.env_state(env),
                                        ref_sqp.SQPState(U))
    assert_sqp_outputs_equal(out, ref_out)
    assert bool((out[2]["accepted"] == -1).all())


@pytest.mark.parametrize("a,b,gap", [
    (math.nan, math.nan, 0.0), (math.inf, math.inf, 0.0),
    (-math.inf, -math.inf, 0.0), (math.nan, 1.0, math.inf),
    (1.0, math.nan, math.inf), (math.inf, -math.inf, math.inf),
    (math.inf, 1.0, math.inf), (math.nan, math.inf, math.inf),
    (1.0, 1.25, 0.25)])
def test_finite_gap_rule(a, b, gap):
    """The same non-finite value at the same place is equal; a non-finite
    value on one side only differs by inf."""
    x = torch.tensor([[0.5, a], [2.0, 2.0]])
    y = torch.tensor([[0.5, b], [2.0, 3.0]])
    assert finite_gap(x, y).tolist() == [gap, 1.0]
    assert finite_gap(torch.tensor([a]), torch.tensor([b])).tolist() == [gap]


def test_cost_gap_is_relative_above_a_floor():
    c = cost_gap(torch.tensor([1.1, 0.0011, math.nan]),
                 torch.tensor([1.0, 0.001, math.nan]))
    assert torch.allclose(c[:2], torch.tensor([0.1, 0.01]), rtol=1e-5)
    assert c[2] == 0.0
