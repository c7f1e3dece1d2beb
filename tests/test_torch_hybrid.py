"""The port's hybrid MPPI + SQP solver against the JAX package's
(solvers/hybrid.py).

Same env states (JAX `reset_one`, carried across with `convert`) and the
same MPPI noise: the standard normals the JAX MPPI stage draws from its
key, handed to the port's `solve` as tests/test_torch_mppi.py does.  S=2
solves x K=4 samples x H=3 steps on the full Bez model, substeps=1.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bez_isaacgym_tpu.solvers.hybrid import HybridSolver as JHybrid  # noqa: E402
from bez_isaacgym_tpu.solvers.mppi import MPPIConfig as JMPPIConfig  # noqa: E402
from bez_isaacgym_tpu.solvers.sqp import SQPConfig as JSQPConfig  # noqa: E402
from bez_isaacgym_tpu.tasks.base import TaskConfig as JTaskConfig  # noqa: E402
from bez_isaacgym_tpu.tasks.kick import KickTask as JKickTask  # noqa: E402
from bez_isaacgym_tpu_torch import convert  # noqa: E402
from bez_isaacgym_tpu_torch.solvers.hybrid import (HybridSolver,  # noqa: E402
                                                   HybridState)
from bez_isaacgym_tpu_torch.solvers.mppi import MPPIConfig  # noqa: E402
from bez_isaacgym_tpu_torch.solvers.sqp import SQPConfig  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.base import TaskConfig  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.kick import KickTask  # noqa: E402

S, K, H, NA = 2, 4, 3, 18
MPPI_KW = dict(horizon=H, num_samples=K, sigma=0.2)


@pytest.fixture(scope="module")
def ttask():
    return KickTask(TaskConfig(substeps=1), device="cpu")


def test_warm_start_seeds_both_stages(ttask):
    solver = HybridSolver(ttask, MPPIConfig(**MPPI_KW),
                          SQPConfig(horizon=H, iterations=1))
    state = solver.init_state(S)
    assert state.mppi.nominal.shape == state.sqp.nominal.shape == (S, H, NA)
    assert not state.mppi.nominal.any() and not state.sqp.nominal.any()
    nominal = 0.1 * torch.ones((S, H, NA))
    warm = solver.warm_start(state, nominal)
    assert torch.equal(warm.mppi.nominal, nominal)
    assert torch.equal(warm.sqp.nominal, nominal)


def test_a_prior_with_the_sqp_stage_raises(ttask):
    def prior(obs):
        return torch.zeros((obs.shape[0], NA))

    with pytest.raises(ValueError, match="MPPI-only"):
        HybridSolver(ttask, MPPIConfig(**MPPI_KW), prior_fn=prior)
    HybridSolver(ttask, MPPIConfig(**MPPI_KW), use_sqp=False, prior_fn=prior)
    with pytest.raises(ValueError, match="horizon"):
        HybridSolver(ttask, MPPIConfig(**MPPI_KW), SQPConfig(horizon=H + 1))
    # The default SQP stage takes MPPI's horizon.
    assert HybridSolver(ttask, MPPIConfig(**MPPI_KW)).sqp.cfg.horizon == H


@pytest.fixture(scope="module")
def solved(ttask):
    jtask = JKickTask(JTaskConfig(substeps=1, use_pallas=False))
    keys = jax.random.split(jax.random.PRNGKey(0), S)
    jenv = jax.jit(jax.vmap(jtask.reset_one))(keys)
    jsolver = JHybrid(jtask, JMPPIConfig(**MPPI_KW),
                      JSQPConfig(horizon=H, iterations=1))
    nominal = np.random.default_rng(5).uniform(-0.1, 0.1, (S, H, NA)).astype(
        np.float32)
    jstate = jsolver.warm_start(None, jnp.asarray(nominal))
    key = jax.random.PRNGKey(11)
    ja, jnew, jinfo = jax.jit(jsolver.solve)(jenv, jstate, key)
    # The standard normals the JAX MPPI stage draws (solvers/mppi.py:212).
    noise = np.array(jax.random.normal(key, (S, K, H, NA), jnp.float32))
    solver = HybridSolver(ttask, MPPIConfig(**MPPI_KW),
                          SQPConfig(horizon=H, iterations=1))
    tenv = convert.env_state(jax.tree.map(np.asarray, jenv))
    state = solver.warm_start(solver.init_state(S), torch.as_tensor(nominal))
    ta, tnew, tinfo = solver.solve(tenv, state, noise=torch.as_tensor(noise))
    return dict(j=(np.asarray(ja), jnew, {k: np.asarray(v)
                                           for k, v in jinfo.items()}),
                t=(ta, tnew, tinfo), solver=solver, tenv=tenv, noise=noise,
                state=state)


def test_solve_matches_jax(solved):
    ja, jnew, jinfo = solved["j"]
    ta, tnew, tinfo = solved["t"]
    assert isinstance(tnew, HybridState) and ta.shape == (S, NA)
    # MPPI's scores agree to 1e-4 (tests/test_torch_mppi.py's bar), so its
    # softmax nominal does to 1e-5; the SQP polish of that nominal then
    # agrees as a whole solve does (tests/test_torch_sqp.py's bars).
    for k in ("best_score", "mean_score"):
        np.testing.assert_allclose(tinfo[k].numpy(), jinfo[k], atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(tinfo["cost"].numpy(), jinfo["cost"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ta.numpy(), ja, atol=1e-4)
    for stage in ("mppi", "sqp"):
        np.testing.assert_allclose(
            getattr(tnew, stage).nominal.numpy(),
            np.asarray(getattr(jnew, stage).nominal), atol=1e-4,
            err_msg=stage)
    # The polished sequence seeds the next MPPI solve.
    assert torch.equal(tnew.mppi.nominal, tnew.sqp.nominal)


def test_polish_never_raises_the_mppi_nominals_cost(solved):
    """The SQP stage accepts a step only if it lowers the cost of the
    nominal MPPI handed it (test_solvers.py's hybrid property)."""
    solver, tenv, state = solved["solver"], solved["tenv"], solved["state"]
    _, mstate, _ = solver.mppi.solve(tenv, state.mppi,
                                     noise=torch.as_tensor(solved["noise"]))
    before = solver.sqp._rollout_cost(tenv, mstate.nominal)
    assert torch.all(solved["t"][2]["cost"] <= before + 1e-6)


def test_without_the_sqp_stage_it_is_mppi(solved, ttask):
    solver = HybridSolver(ttask, MPPIConfig(**MPPI_KW), use_sqp=False)
    noise = torch.as_tensor(solved["noise"])
    a, new, _ = solver.solve(solved["tenv"], solved["state"], noise=noise)
    _, mstate, _ = solver.mppi.solve(solved["tenv"], solved["state"].mppi,
                                     noise=noise)
    assert torch.equal(a, mstate.nominal[:, 0])
    assert torch.equal(new.mppi.nominal, mstate.nominal)
    assert torch.equal(new.sqp.nominal, solved["state"].sqp.nominal)
