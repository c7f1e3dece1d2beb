"""The port's SQP/iLQR solver against the JAX package's (solvers/sqp.py).

Both sides start from the same states: JAX `reset_one` (in contact: the
feet on the ground), carried across with `convert`, and the airborne state
of tests/test_solvers.py (base at 0.6 m, joint velocities 0.4 rad/s, the
ball far away).  The JAX side runs `TaskConfig(substeps=1,
use_pallas=False)`, as tests/test_solvers.py sets it up; the port's
forward rollouts take the task's batched step (the plain engine on the
CPU) and its linearization the plain engine under torch.func.  Each
`linearize` mode is held against the same JAX mode, and the behavioural
properties of test_solvers.py hold on the port.  Whole solves (S=2, H=3)
against JAX's are in tests/test_torch_sqp_solve.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bez_isaacgym_tpu.solvers import sqp as jsqp  # noqa: E402
from bez_isaacgym_tpu.tasks.base import TaskConfig as JTaskConfig  # noqa: E402
from bez_isaacgym_tpu.tasks.kick import KickTask as JKickTask  # noqa: E402
from bez_isaacgym_tpu_torch import convert  # noqa: E402
from bez_isaacgym_tpu_torch.solvers.sqp import (NX, SQPConfig,  # noqa: E402
                                                SQPSolver, SQPState,
                                                flatten_physics,
                                                unflatten_physics)
from bez_isaacgym_tpu_torch.tasks.base import TaskConfig  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.kick import KickTask  # noqa: E402

S, H, NA = 2, 3, 18


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jtask(substeps=1):
    return JKickTask(JTaskConfig(substeps=substeps, use_pallas=False))


@pytest.fixture(scope="module")
def case():
    jtask = _jtask()
    keys = jax.random.split(jax.random.PRNGKey(0), S)
    jenv = jax.jit(jax.vmap(jtask.reset_one))(keys)
    env0 = jax.tree.map(lambda x: x[0], jenv)
    air = env0._replace(physics=env0.physics._replace(
        base_pos=env0.physics.base_pos.at[2].set(0.6),
        q=jtask.default_dof_pos,
        qd=jnp.full(NA, 0.4, jnp.float32),
        ball_pos=jnp.asarray([5.0, 0.0, 0.5], jnp.float32)))
    # Row 0 airborne, row 1 in contact.
    jrows = jax.tree.map(lambda a, b: jnp.stack([a, b]), air, env0)
    u = 0.05 * np.sin(np.arange(NA, dtype=np.float32))
    return dict(jtask=jtask, jenv=jenv, jrows=jrows, u=u,
                tenv=convert.env_state(_np(jenv)),
                trows=convert.env_state(_np(jrows)))


def _port_task(substeps=1):
    return KickTask(TaskConfig(substeps=substeps), device="cpu")


def test_flatten_round_trip_and_layout(case):
    ph = case["trows"].physics
    x = flatten_physics(ph)
    assert x.shape == (2, NX) and NX == jsqp.NX == 58
    back = unflatten_physics(x, ph)
    for f in ph._fields:
        assert torch.equal(getattr(back, f), getattr(ph, f)), f
    jx = jax.vmap(jsqp.flatten_physics)(case["jrows"].physics)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    # The template's ball quat and sensor fields survive; the rest is x.
    moved = unflatten_physics(x + 1.0, ph)
    assert torch.equal(moved.ball_quat, ph.ball_quat)
    assert torch.equal(moved.q, ph.q + 1.0)


def _linearize_both(case, mode, substeps=1):
    jtask = case["jtask"] if substeps == 1 else _jtask(substeps)
    jrows = case["jrows"]
    js = jsqp.SQPSolver(jtask, jsqp.SQPConfig(horizon=4, linearize=mode))
    x = jax.vmap(jsqp.flatten_physics)(jrows.physics)
    u = jnp.broadcast_to(jnp.asarray(case["u"]), (2, NA))
    jA, jB = jax.jit(jax.vmap(js.linearize_dynamics))(jrows, x, u)
    ts = SQPSolver(_port_task(substeps), SQPConfig(horizon=4, linearize=mode))
    tA, tB = ts.linearize_dynamics(
        case["trows"], flatten_physics(case["trows"].physics),
        torch.as_tensor(np.asarray(u)))
    return np.asarray(jA), np.asarray(jB), tA.numpy(), tB.numpy()


@pytest.mark.parametrize("mode", ["struct", "struct_z", "jacfwd"])
def test_linearize_matches_jax(case, mode):
    """Exact forward-mode derivatives on both sides: test_solvers.py's
    struct-vs-jacfwd bars (atol 1e-4, rtol 1e-3), airborne and in contact
    (entries up to ~25)."""
    jA, jB, tA, tB = _linearize_both(case, mode)
    assert tA.shape == (2, NX, NX) and tB.shape == (2, NX, NA)
    for row in (0, 1):
        np.testing.assert_allclose(tA[row], jA[row], atol=1e-4, rtol=1e-3,
                                   err_msg=f"A row {row}")
        np.testing.assert_allclose(tB[row], jB[row], atol=1e-4, rtol=1e-3,
                                   err_msg=f"B row {row}")
    # Head-motor columns are zeroed by the action pipeline.
    np.testing.assert_array_equal(tB[:, :, 0:2], 0.0)


def test_linearize_fd_matches_jax(case):
    """Central differences with step 1e-3 on both sides: an f32 rounding
    difference of ~1e-6 between the packages' steps becomes ~5e-4 in a
    quotient over 2e-3, so the bar is 5e-3 (test_solvers.py holds FD to
    jacfwd at 2e-2)."""
    jA, jB, tA, tB = _linearize_both(case, "fd")
    np.testing.assert_allclose(tA, jA, atol=5e-3, rtol=1e-3)
    np.testing.assert_allclose(tB, jB, atol=5e-3, rtol=1e-3)


def test_struct_chains_substeps_like_jax(case):
    """substeps=2: J = A_1 (A_0 [I|0] + [0|B_0]) + [0|B_1], the chain."""
    jA, jB, tA, tB = _linearize_both(case, "struct", substeps=2)
    np.testing.assert_allclose(tA, jA, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(tB, jB, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("kw", [dict(iterations=1),
                                dict(iterations=2, warm_reg=0.5)],
                         ids=["one_iteration", "two_tethered"])
def test_parallel_riccati_solve_equals_sequential(case, kw):
    """The same solve with either backward pass: the same accepted steps,
    actions within the passes' own agreement (test_riccati.py's bars)."""
    U = torch.as_tensor(np.random.default_rng(4).uniform(
        -0.2, 0.2, (S, H, NA)).astype(np.float32))
    out = [SQPSolver(_port_task(), SQPConfig(horizon=H, parallel_riccati=p,
                                             **kw))
           .solve(case["tenv"], SQPState(nominal=U)) for p in (False, True)]
    (a_s, n_s, i_s), (a_p, n_p, i_p) = out
    assert torch.equal(i_s["accepted"], i_p["accepted"])
    torch.testing.assert_close(a_p, a_s, rtol=2e-3, atol=2e-4)
    torch.testing.assert_close(n_p.nominal, n_s.nominal, rtol=2e-3,
                               atol=2e-4)


class QuadraticTask(KickTask):
    """test_solvers.py's quadratic toy on the port: a smooth joint-tracking
    cost, so improvement properties are exact."""

    def reward_done(self, state, action):
        err = state.physics.q - (self.default_dof_pos + 0.3)
        return -torch.sum(err * err, dim=-1), \
            torch.zeros(err.shape[0], dtype=torch.bool)


def test_cost_never_increases(case):
    """test_solvers.py::test_sqp_cost_never_increases on the port: the
    final cost is at most the nominal's rollout cost."""
    solver = SQPSolver(_port_task(), SQPConfig(horizon=4, iterations=2))
    U0 = torch.zeros((S, 4, NA))
    base = solver._rollout_cost(case["tenv"], U0)
    _, _, info = solver.solve(case["tenv"], SQPState(nominal=U0))
    assert torch.all(info["cost"] <= base + 1e-4), (info["cost"], base)


def test_improves_a_bad_nominal_and_frozen_iterations_descend(case):
    """test_solvers.py's quadratic-toy properties on the port: from a zero
    nominal the cost strictly falls; the frozen-Jacobian 2-iteration solve
    beats the nominal, is no worse than 1 iteration, and keeps 95% of the
    exact 2-iteration gain."""
    task = QuadraticTask(TaskConfig(substeps=1), device="cpu")
    U0 = torch.zeros((S, 4, NA))
    base = SQPSolver(task, SQPConfig(horizon=4))._rollout_cost(
        case["tenv"], U0)

    def run(iterations, relin):
        solver = SQPSolver(task, SQPConfig(horizon=4, iterations=iterations,
                                           relinearize_every=relin))
        return solver.solve(case["tenv"], SQPState(nominal=U0))[2]["cost"]

    c1, c2_frozen, c2_exact = run(1, 1), run(2, 2), run(2, 1)
    assert torch.all(c1 < base)
    assert torch.all(c2_frozen < base)
    assert torch.all(c2_frozen <= c1 + 1e-6)
    assert torch.all(base - c2_frozen >= 0.95 * (base - c2_exact) - 1e-6)


def test_warm_reg_tethers_to_the_warm_start(case):
    """test_solvers.py::test_sqp_warm_reg_tethers_to_warm_start on the
    port."""
    task = QuadraticTask(TaskConfig(substeps=1), device="cpu")
    U0 = 0.1 * torch.ones((S, 4, NA))

    def dev(warm_reg):
        solver = SQPSolver(task, SQPConfig(horizon=4, iterations=2,
                                           warm_reg=warm_reg))
        _, st, _ = solver.solve(case["tenv"], SQPState(nominal=U0))
        # The first polished action is the shifted nominal's step back.
        U = torch.cat([solver.solve(case["tenv"], SQPState(nominal=U0))[0]
                       [:, None], st.nominal[:, :-1]], dim=1)
        return float((U - U0).abs().max())

    free, soft, hard = dev(0.0), dev(1.0), dev(1e6)
    assert hard < 1e-3
    assert soft < free + 1e-6
    assert free > 1e-3


def test_nan_gains_never_reach_an_action(case, monkeypatch):
    """Overflowed Riccati gains (NaN) make every candidate's actions NaN.
    A step function that maps NaN targets to joint limits (as the CUDA
    kernel's clamps do) must not let them score: the solve keeps its
    nominal, as the JAX package's does through NaN states."""
    from bez_isaacgym_tpu_torch.solvers import sqp as tsqp

    task = _port_task()
    real_step = task._step_physics_batch

    def sanitizing_step(dyn, ph, targets):
        return real_step(dyn, ph, torch.where(torch.isnan(targets),
                                              task.dof_upper, targets))

    monkeypatch.setattr(task, "_step_physics_batch", sanitizing_step)
    real_backward = tsqp.sequential_backward

    def nan_gains(*a):
        g = real_backward(*a)
        return g._replace(K=torch.full_like(g.K, float("nan")))

    monkeypatch.setattr(tsqp, "sequential_backward", nan_gains)
    U = torch.as_tensor(np.random.default_rng(6).uniform(
        -0.2, 0.2, (S, H, NA)).astype(np.float32))
    solver = SQPSolver(task, SQPConfig(horizon=H, iterations=1))
    actions, _, info = solver.solve(case["tenv"], SQPState(nominal=U))
    assert torch.equal(info["accepted"], torch.full((S,), -1))
    assert torch.equal(actions, U[:, 0])
    torch.testing.assert_close(info["cost"],
                               solver._rollout_cost(case["tenv"], U))
