"""The port's MPPI solve against the JAX solve: the slice end to end.

Same env states (JAX `reset_one`, carried across with `convert`), same
nominal, and the same sampling noise: the standard normals the JAX solver
draws from its key (solvers/mppi.py:212) are handed to the port's `solve`.
S=2 solves x K=4 samples x H=3 steps on the full Bez model, substeps=1.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bez_isaacgym_tpu.solvers.mppi import MPPIConfig as JMPPIConfig  # noqa: E402
from bez_isaacgym_tpu.solvers.mppi import MPPISolver as JMPPISolver  # noqa: E402
from bez_isaacgym_tpu.solvers.mppi import MPPIState as JMPPIState  # noqa: E402
from bez_isaacgym_tpu.tasks.base import TaskConfig as JTaskConfig  # noqa: E402
from bez_isaacgym_tpu.tasks.kick import KickTask as JKickTask  # noqa: E402
from bez_isaacgym_tpu_torch import convert  # noqa: E402
from bez_isaacgym_tpu_torch.solvers.mppi import (MPPIConfig, MPPISolver,  # noqa: E402
                                                 balance_score)
from bez_isaacgym_tpu_torch.tasks.base import TaskConfig  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.kick import KickTask  # noqa: E402

S, K, H, NA = 2, 4, 3, 18

CONFIGS = {
    "average": dict(),
    "elite": dict(elite=True),
    "zero_nominal": dict(elite=True, zero_nominal_sample=True),
    # Closed loop around a policy prior with 2 absolute recovery samples;
    # gate 2.0 sits above any balance score, so recovery is always eligible.
    "prior_recovery": dict(elite=True, zero_nominal_sample=True,
                           recovery_samples=2, recovery_gate=2.0),
}
R_PRIOR = 2
W_PRIOR = np.random.default_rng(11).normal(0, 0.01, (54, NA)).astype(
    np.float32)


@pytest.fixture(scope="module")
def tasks():
    jtask = JKickTask(JTaskConfig(substeps=1, use_pallas=False))
    ttask = KickTask(TaskConfig(substeps=1), device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(0), S)
    jenv = jax.jit(jax.vmap(jtask.reset_one))(keys)
    tenv = convert.env_state(jax.tree.map(np.asarray, jenv))
    rng = np.random.default_rng(3)
    nominal = rng.uniform(-0.2, 0.2, (S, H, NA)).astype(np.float32)
    return jtask, ttask, jenv, tenv, nominal


@pytest.fixture(scope="module", params=list(CONFIGS))
def solved(request, tasks):
    jtask, ttask, jenv, tenv, nominal = tasks
    kw = CONFIGS[request.param]
    prior = "recovery_samples" in kw
    key = jax.random.PRNGKey(7)
    jsolver = JMPPISolver(
        jtask, JMPPIConfig(horizon=H, num_samples=K, **kw),
        prior_fn=(lambda o: o @ jnp.asarray(W_PRIOR)) if prior else None)
    ja, jm, jinfo = jax.jit(jsolver.solve)(
        jenv, JMPPIState(nominal=jnp.asarray(nominal)), key)
    # The standard normals the JAX solve draws (solvers/mppi.py:212, and
    # :220-222 for the recovery family).
    noise = np.array(jax.random.normal(key, (S, K, H, NA), jnp.float32))
    rec = np.array(jax.random.normal(jax.random.fold_in(key, 1),
                                     (S, R_PRIOR, H, NA), jnp.float32))
    tsolver = MPPISolver(
        ttask, MPPIConfig(horizon=H, num_samples=K, **kw),
        prior_fn=(lambda o: o @ torch.as_tensor(W_PRIOR)) if prior else None)
    mstate = convert.mppi_state(JMPPIState(nominal=nominal))
    ta, tm, tinfo = tsolver.solve(tenv, mstate, noise=torch.as_tensor(noise),
                                  recovery_noise=torch.as_tensor(rec))
    return (np.asarray(ja), np.asarray(jm.nominal),
            {k: np.asarray(v) for k, v in jinfo.items()},
            ta.numpy(), tm.nominal.numpy(), {k: v.numpy()
                                              for k, v in tinfo.items()})


def test_solve_actions_match_jax(solved):
    ja, jnom, _, ta, tnom, _ = solved
    assert ta.shape == (S, NA)
    # Scores agree to ~1e-5 (below), so the softmax weights (temperature
    # 0.05) and the elite choice agree; actions are the weighted or chosen
    # sampled sequences, equal to f32 rounding: 1e-5.
    np.testing.assert_allclose(ta, ja, atol=1e-5)
    np.testing.assert_allclose(tnom, jnom, atol=1e-5)


def test_solve_scores_match_jax(solved):
    _, _, jinfo, _, _, tinfo = solved
    # Three control steps of the same f32 engine and reward: 1e-4 absolute
    # on scores of magnitude ~1.
    for k in ("best_score", "mean_score"):
        np.testing.assert_allclose(tinfo[k], jinfo[k], atol=1e-4)
    np.testing.assert_allclose(tinfo["ess"], jinfo["ess"], rtol=1e-3)


def test_balance_score_matches_jax(tasks):
    from bez_isaacgym_tpu.solvers.mppi import balance_score as jbalance

    _, _, jenv, tenv, _ = tasks
    np.testing.assert_allclose(balance_score(tenv.physics).numpy(),
                               np.asarray(jbalance(jenv.physics)), atol=1e-6)


def test_zero_nominal_sample_is_the_nominal(tasks):
    """With zero_nominal_sample, sample 0 replays the nominal exactly: a
    noise of all-large values cannot move it."""
    _, ttask, _, tenv, nominal = tasks
    solver = MPPISolver(ttask, MPPIConfig(horizon=H, num_samples=K,
                                          zero_nominal_sample=True,
                                          elite=True))
    noise = torch.full((S, K, H, NA), 50.0)   # other samples clip hard
    mstate = convert.mppi_state(JMPPIState(nominal=nominal))
    _, new, info = solver.solve(tenv, mstate, noise=noise)
    scores0, _ = solver._rollout_scores(tenv, torch.as_tensor(nominal))
    assert torch.all(info["best_score"] >= scores0 - 1e-5)
