"""The port's SQP kick evals (the hybrid solver and sqp-policy) against
the JAX package's, from the same states.  Each JAX eval takes minutes to
trace on the CPU, so they get a file, and a test worker, of their own;
tests/test_torch_kick_eval.py holds the rest of the serving slice.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bez_isaacgym_tpu.tasks.base import TaskConfig as JTaskConfig  # noqa: E402
from bez_isaacgym_tpu.tasks.kick import KickTask as JKickTask  # noqa: E402
from bez_isaacgym_tpu_torch import convert  # noqa: E402
from bez_isaacgym_tpu_torch.eval import kick_eval  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.kick import KickTask  # noqa: E402

from test_torch_kick_eval import KICK, NA, _np  # noqa: E402


@pytest.mark.parametrize("path", ["hybrid", "sqp_policy"])
def test_sqp_paths_raise_naming_the_roadmap_item(path, monkeypatch):
    """The SQP evals (once raising, now ported) against the JAX evals from
    the same states: both start from the JAX `reset_one` states of the
    eval's seed, run 2 ticks at S=2, H=3, substeps=1, and must return the
    same dict: every key, the rates exactly, the ball progress within
    1e-5 relative.  The hybrid's MPPI noise is the JAX eval's own draw
    (its key PRNGKey(seed + 1), split once per tick), fed to the port's
    solve."""
    from bez_isaacgym_tpu.eval import kick_eval as jeval
    from bez_isaacgym_tpu_torch.solvers.hybrid import HybridSolver

    n, steps, H, K = 2, 2, 3, 4
    jtask = JKickTask(JTaskConfig(substeps=1, use_pallas=False))
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    first = convert.env_state(_np(jax.jit(jax.vmap(jtask.reset_one))(keys)))
    # The JAX evals build their task with the default (Pallas) config; the
    # CPU takes the XLA path either way, made explicit here.
    monkeypatch.setattr(jeval, "TaskConfig", lambda **kw: JTaskConfig(
        use_pallas=False, **kw))
    if path == "hybrid":
        kw = dict(num_envs=n, steps=steps, horizon=H, num_samples=K,
                  substeps=1, use_sqp=True)
        ref = jeval.eval_mppi(**kw)
        draws, key = [], jax.random.PRNGKey(1)
        for _ in range(steps):
            key, sub = jax.random.split(key)
            draws.append(torch.as_tensor(np.array(jax.random.normal(
                sub, (n, K, H, NA), jnp.float32))))
        real_solve = HybridSolver.solve
        monkeypatch.setattr(
            HybridSolver, "solve", lambda self, env, st, gen=None:
            real_solve(self, env, st, gen, noise=draws.pop(0)))
        run = lambda: kick_eval.eval_mppi(device="cpu", **kw)  # noqa: E731
    else:
        kw = dict(num_envs=n, steps=steps, horizon=H, substeps=1,
                  warm_reg=0.5, policy_prior=KICK)
        ref = jeval.eval_sqp_policy(**kw)
        run = lambda: kick_eval.eval_sqp_policy(device="cpu",  # noqa: E731
                                                **kw)
    real_reset, resets = KickTask.reset, []

    def port_reset(self, gen, num, dr_step=0):
        resets.append(num)
        return first if len(resets) == 1 else real_reset(self, gen, num,
                                                          dr_step)

    monkeypatch.setattr(KickTask, "reset", port_reset)
    res = run()
    assert resets and resets[0] == n
    if path == "hybrid":
        assert not draws, "every tick took the JAX noise"
    assert set(res) == set(ref) and res["config"] == ref["config"]
    for k in ("success_rate", "kicked_rate", "fall_rate"):
        assert res[k] == ref[k], k
    np.testing.assert_allclose(res["mean_ball_progress_m"],
                               ref["mean_ball_progress_m"], rtol=1e-5,
                               atol=1e-7)

