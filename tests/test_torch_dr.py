"""The port's domain randomization against the JAX package's.

JAX and torch random streams differ, so the draws are held to their
distributions and the deterministic parts (schedules, bounds, the frequency
gate) to the JAX functions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from bez_isaacgym_tpu.tasks import dr as jdr  # noqa: E402
from bez_isaacgym_tpu_torch.tasks import dr  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.base import TaskConfig  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.kick import KickTask  # noqa: E402

STEPS = [0, 1, 1500, 2999, 3000, 6000]


@pytest.mark.parametrize("schedule", [None, "linear", "constant"])
def test_schedule_scaling_matches_jax(schedule):
    kw = dict(schedule=schedule, schedule_steps=3000)
    got = dr._sched_scaling(dr.RandSpec(**kw), torch.tensor(STEPS), "cpu")
    want = [float(jdr._sched_scaling(jdr.RandSpec(**kw), s)) for s in STEPS]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("operation", ["additive", "scaling"])
@pytest.mark.parametrize("distribution", ["gaussian", "uniform"])
def test_draws_follow_the_jax_distribution(operation, distribution):
    """At schedule position 1500 of 3000 (s=0.5): mean and spread of 20k
    draws match the JAX sampler's (3-sigma bars on the sample mean)."""
    rng_ = (0.5, 1.5) if distribution == "uniform" else (0.2, 0.4)
    kw = dict(range=rng_, operation=operation, distribution=distribution,
              schedule="linear")
    n = 20000
    import jax

    want = np.asarray(jdr.sample(jax.random.PRNGKey(0), jdr.RandSpec(**kw),
                                 (n,), 1500))
    got = dr.sample(torch.Generator().manual_seed(0), dr.RandSpec(**kw),
                    (n,), 1500).numpy()
    sd = want.std()
    assert abs(got.mean() - want.mean()) < 3 * sd * np.sqrt(2 / n) + 1e-6
    assert abs(got.std() - sd) < 0.03 * sd
    if distribution == "uniform":
        assert got.min() >= want.min() - 0.01 * sd
        assert got.max() <= want.max() + 0.01 * sd


def test_correlated_component_shifts_like_jax():
    kw = dict(range=(0.0, 0.1), range_correlated=(1.0, 0.0))
    got = dr.sample(torch.Generator().manual_seed(1), dr.RandSpec(**kw),
                    (5000,), 0).numpy()
    assert abs(got.mean() - 1.0) < 0.01


def test_disabled_spec_returns_value():
    v = torch.arange(4.0)
    assert dr.apply(torch.Generator(), dr.RandSpec(enabled=False), v, 0) is v


def test_task_with_dr_randomizes_and_gates():
    cfg = TaskConfig(substeps=1, dr=dr.DomainRandConfig(enabled=True,
                                                        frequency=2))
    task = KickTask(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    env = task.reset(gen, 6, dr_step=3000)
    dyn = env.dyn
    assert (dyn.dof_lower <= dyn.dof_upper).all()
    assert dyn.kp.std() > 0 and dyn.mass_scale.std() > 0
    assert not torch.equal(dyn.ground_friction[0], dyn.ground_friction[1])
    # Envs 0-2 reset this step; env 0 is due (2 steps since its last
    # randomization), env 1 is not, env 2 is due but mass is setup-only.
    env = env._replace(
        done=torch.tensor([True, True, True, False, False, False]),
        dr_step=torch.tensor([5, 5, 5, 5, 5, 5], dtype=torch.int32),
        last_rand_step=torch.tensor([4, 5, 0, 0, 0, 0], dtype=torch.int32))
    out = task.step_batch(env, torch.zeros((6, 18)), gen)
    new = out.state
    assert not torch.equal(new.dyn.kp[0], dyn.kp[0])        # re-randomized
    assert torch.equal(new.dyn.kp[1], dyn.kp[1])            # gated off
    assert torch.equal(new.dyn.kp[3], dyn.kp[3])            # not reset
    assert torch.equal(new.dyn.mass_scale, dyn.mass_scale)  # setup only
    assert new.last_rand_step.tolist() == [6, 5, 6, 0, 0, 0]
    assert (new.dr_step == 6).all()
    assert torch.isfinite(out.obs).all()
