"""The port's walk, orient and goalie tasks and the registry, against the
JAX package on the CPU.

Both sides start from the same batched states: JAX `reset_one` states,
perturbed with a seeded numpy RNG (so that the reward branches, wins,
falls, strays, drifts, passes and stops all occur) and carried across with
`bez_isaacgym_tpu_torch.convert`.  Actions come from the same RNG.  The JAX
side runs without Pallas.  S = 4 envs, substeps = 1.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bez_isaacgym_tpu.tasks import registry as jreg  # noqa: E402
from bez_isaacgym_tpu_torch import convert  # noqa: E402
from bez_isaacgym_tpu_torch.ops import substep as ss  # noqa: E402
from bez_isaacgym_tpu_torch.tasks import registry as treg  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.walk import WalkTask, walk_config  # noqa: E402

S = 4
TASKS = ("bez_walk", "bez_orient", "bez_goalie")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _yaw_quat(yaw):
    return np.stack([np.zeros_like(yaw), np.zeros_like(yaw),
                     np.sin(yaw / 2), np.cos(yaw / 2)], -1)


def _perturb(name, jtask, jstate, rng):
    """Reset states moved so that every branch of the task's reward_done
    is taken by some env."""
    ph = _np(jstate.physics)
    q, base_u = ph.q.copy(), rng.uniform(-0.3, 0.3, (S, 6))
    base_pos, base_quat = ph.base_pos.copy(), ph.base_quat.copy()
    ball_pos, ball_vel = ph.ball_pos.copy(), ph.ball_vel.copy()
    goal = np.asarray(jstate.goal).copy()
    q0 = np.asarray(jtask.default_dof_pos)
    # env 0 at rest in the ready pose (the win tests); env 3 tilted 60
    # degrees about x (a fall).
    q[0], base_u[0] = q0, 0.0
    base_quat[3] = [np.sin(0.5236), 0.0, 0.0, np.cos(0.5236)]
    if name == "bez_walk":
        goal[0] = base_pos[0, :2] + [0.02, 0.01]    # won
        goal[1] = [0.3, 0.4]
        base_pos[1, :2] = [0.6, 0.8]                 # strayed: past the goal
        goal[2] = [-1.5, 0.5]
    elif name == "bez_orient":
        # Yaw beyond, short of and at the goal angle: the signed test.
        base_quat[:3] = _yaw_quat(np.array([1.5708, 2.4, 0.7]))
        base_pos[2, :2] = [0.25, 0.2]                # drifted
    else:
        ball_vel[0] = 0.0                            # stopped
        ball_pos[1, 0] = base_pos[1, 0] - 0.2        # passed
        ball_pos[2] = [1.2, 0.1, 0.08]               # kicked, moving
        ball_vel[2] = [1.5, 0.3, 0.0]
    physics = jstate.physics._replace(**{
        k: jnp.asarray(v, jnp.float32) for k, v in dict(
            q=q, base_u=base_u, base_pos=base_pos, base_quat=base_quat,
            ball_pos=ball_pos, ball_vel=ball_vel).items()})
    return jstate._replace(
        physics=physics, goal=jnp.asarray(goal, jnp.float32),
        progress=jnp.asarray(rng.integers(0, 5, S), jnp.int32),
        prev_lin_vel=jnp.asarray(rng.uniform(-0.2, 0.2, (S, 3)),
                                 jnp.float32))


def _case(name, jcfg=None, cfg=None, edit=None):
    """Both tasks at substeps=1, the JAX states perturbed (and then edited
    by `edit(jstate) -> jstate`), and the JAX side's results."""
    jcfg = jcfg or jreg.default_configs[name]()
    jtask = jreg.make_task(name, dataclasses.replace(
        jcfg, substeps=1, use_pallas=False))
    cfg = cfg or treg.default_configs[name]()
    ttask = treg.make_task(name, dataclasses.replace(cfg, substeps=1),
                           device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(0), S)
    jstate = jax.jit(jax.vmap(jtask.reset_one))(keys)
    rng = np.random.default_rng(0)
    jstate = _perturb(name, jtask, jstate, rng)
    if edit is not None:
        jstate = edit(jstate)
    actions = rng.uniform(-0.3, 0.3, (S, 18)).astype(np.float32)
    ja = jnp.asarray(actions)
    return dict(
        jtask=jtask, ttask=ttask, tstate=convert.env_state(_np(jstate)),
        actions=torch.as_tensor(actions),
        jout=_np(jax.jit(jtask.step_batch)(jstate, ja)),
        jobs=_np(jax.jit(jax.vmap(jtask.observe))(jstate, ja)),
        jrd=_np(jax.jit(jax.vmap(jtask.reward_done))(jstate, ja)))


@pytest.fixture(scope="module", params=TASKS)
def case(request):
    return _case(request.param)


def test_observe_matches_jax(case):
    obs, st = case["ttask"].observe(case["tstate"], case["actions"])
    jobs, jst = case["jobs"]
    assert obs.shape == (S, case["jtask"].num_obs)
    # f32 elementwise math in both; the IMU divides a velocity difference
    # by dt = 1/60, so 1e-4 absolute covers the amplified rounding.
    np.testing.assert_allclose(obs.numpy(), jobs, atol=1e-4)
    np.testing.assert_allclose(st.prev_lin_vel.numpy(), jst.prev_lin_vel,
                               atol=1e-6)


def test_reward_done_matches_jax(case):
    reward, done = case["ttask"].reward_done(case["tstate"], case["actions"])
    jr, jd = case["jrd"]
    np.testing.assert_array_equal(done.numpy(), jd)
    # The perturbed states end some episodes, not all.
    assert 1 <= int(jd.sum()) < S
    # Same f32 formula; norms and atan2 round differently: 1e-5 relative
    # to the rewards' scale (the walk's win pays up to 1000, the goalie's
    # pass costs 10000).
    np.testing.assert_allclose(reward.numpy(), jr, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("field", ["q", "qd", "base_pos", "base_quat",
                                   "base_u", "ball_pos", "ball_vel"])
def test_step_batch_physics_matches_jax(case, field):
    out = case["ttask"].step_batch(case["tstate"], case["actions"],
                                   torch.Generator().manual_seed(0))
    ref = getattr(case["jout"].state.physics, field)
    got = getattr(out.state.physics, field).numpy()
    # One control step of the same f32 engine (test_torch_kick's bars):
    # velocities carry the 1/h amplification.
    atol = 1e-4 if field in ("qd", "base_u", "ball_vel") else 1e-5
    np.testing.assert_allclose(got, ref, atol=atol)


def test_step_batch_outputs_match_jax(case):
    out = case["ttask"].step_batch(case["tstate"], case["actions"],
                                   torch.Generator().manual_seed(0))
    j = case["jout"]
    np.testing.assert_array_equal(out.done.numpy(), j.done)
    np.testing.assert_array_equal(out.time_out.numpy(), j.time_out)
    np.testing.assert_array_equal(out.state.progress.numpy(),
                                  j.state.progress)
    np.testing.assert_allclose(out.reward.numpy(), j.reward, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out.obs.numpy(), j.obs, atol=1e-4)


def test_walk_branches_are_taken():
    """The walk case really wins, strays and falls (so the parity above
    covers those branches)."""
    reward, done = _case("bez_walk")["jrd"]
    assert done[0] and reward[0] > 900.0          # won
    assert done[1] and reward[1] == -100.0        # strayed
    assert done[3] and reward[3] == -100.0        # fell
    assert not done[2]


def test_walk_win_shaping_matches_jax():
    """Goals 6 cm ahead of every robot: inside the shaping kernel, outside
    the 5 cm win radius."""
    def near(jstate):
        return jstate._replace(
            goal=jstate.physics.base_pos[:, :2] + jnp.array([0.06, 0.0]))

    c = _case("bez_walk",
              dataclasses.replace(jreg.default_configs["bez_walk"](),
                                  win_shaping=3.0),
              dataclasses.replace(walk_config(), win_shaping=3.0), near)
    reward, done = c["ttask"].reward_done(c["tstate"], c["actions"])
    jr, jd = c["jrd"]
    np.testing.assert_array_equal(done.numpy(), jd)
    np.testing.assert_allclose(reward.numpy(), jr, rtol=1e-5, atol=1e-5)
    # The bonus (>= 3 * exp(-(0.06/0.08)^2) * 0.5 = 0.85 upright) is paid
    # to the upright envs; the fallen env 3 gets the -100 override.
    plain, _ = _walk().reward_done(c["tstate"], c["actions"])
    assert ((reward - plain)[:3] > 0.8).all()
    assert reward[3] == plain[3] == -100.0


def test_goalie_ball_against_a_box_matches_jax():
    """The shot meets the box model's shin: one control step with the
    ball inside a collision box's reach, moving at -10 m/s."""
    jcfg = dataclasses.replace(jreg.default_configs["bez_goalie"](),
                               substeps=1, use_pallas=False)
    jtask = jreg.make_task("bez_goalie", jcfg)
    ttask = treg.make_task("bez_goalie", dataclasses.replace(
        treg.default_configs["bez_goalie"](), substeps=1), device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(3), S)
    jstate = jax.jit(jax.vmap(jtask.reset_one))(keys)
    rng = np.random.default_rng(3)
    ball = np.tile([0.07, 0.04, 0.085], (S, 1)) + rng.uniform(
        -0.01, 0.01, (S, 3))
    jstate = jstate._replace(physics=jstate.physics._replace(
        ball_pos=jnp.asarray(ball, jnp.float32)))
    tstate = convert.env_state(_np(jstate))
    tables = ss.KernelTables(ttask.model, ttask.scene)
    act = ss.contact_activity(tables, ss.pack_state(tstate.physics))
    assert act.box.sum() >= S, act                 # every env's ball in
    actions = rng.uniform(-0.3, 0.3, (S, 18)).astype(np.float32)
    jout = _np(jax.jit(jtask.step_batch)(jstate, jnp.asarray(actions)))
    tout = ttask.step_batch(tstate, torch.as_tensor(actions),
                            torch.Generator().manual_seed(0))
    # The boxes pushed the ball: it lost most of its 10 m/s.
    assert (np.abs(jout.state.physics.ball_vel[:, 0] + 10.0) > 1.0).all()
    for f in ("q", "base_pos", "base_quat", "ball_pos"):
        np.testing.assert_allclose(getattr(tout.state.physics, f).numpy(),
                                   getattr(jout.state.physics, f),
                                   atol=1e-5, err_msg=f)
    for f in ("qd", "base_u", "ball_vel", "ball_ang"):
        # Stiff ball-box contact: the velocities' 1/h amplification.
        np.testing.assert_allclose(getattr(tout.state.physics, f).numpy(),
                                   getattr(jout.state.physics, f),
                                   atol=1e-3, err_msg=f)
    np.testing.assert_array_equal(tout.done.numpy(), jout.done)
    np.testing.assert_allclose(tout.reward.numpy(), jout.reward, rtol=1e-5,
                               atol=1e-4)


def _walk(**kw):
    return WalkTask(dataclasses.replace(walk_config(), substeps=1, **kw),
                    device="cpu")


def test_walk_goals_in_the_box():
    goals = _walk(goal_range=0.5).reset(
        torch.Generator().manual_seed(0), 512).goal.numpy()
    assert np.abs(goals).max() <= 0.5
    # Uniform: every quadrant, out to the edges.
    assert goals.min(0).max() < -0.45 and goals.max(0).min() > 0.45
    assert len(np.unique(goals[:, 0])) == 512


def test_walk_goals_in_the_ring():
    goals = _walk(goal_range=0.5, goal_range_min=0.15).reset(
        torch.Generator().manual_seed(1), 512).goal.numpy()
    r = np.linalg.norm(goals, axis=-1)
    assert r.min() >= 0.15 - 1e-6 and r.max() <= 0.5 + 1e-6
    assert r.min() < 0.17 and r.max() > 0.48
    th = np.arctan2(goals[:, 1], goals[:, 0])
    assert np.histogram(th, bins=8, range=(-np.pi, np.pi))[0].min() > 30


def test_walk_auto_reset_resamples_goals():
    task = _walk()
    gen = torch.Generator().manual_seed(2)
    state = task.reset(gen, S)
    done = torch.tensor([True, False, True, False])
    out = task.step_batch(state._replace(done=done), torch.zeros(S, 18), gen)
    new, old = out.state.goal, state.goal
    assert (new[done] != old[done]).all()
    assert torch.equal(new[~done], old[~done])
    assert (new.abs() <= task.cfg.goal_range).all()


def test_registry_keys_and_classes_match_jax():
    assert set(treg.task_map) == set(jreg.task_map)
    assert set(treg.default_configs) == set(jreg.default_configs)
    for name, jcls in jreg.task_map.items():
        cls = treg.task_map[name]
        assert cls.__name__ == jcls.__name__
        assert (cls.num_obs, cls.has_ball) == (jcls.num_obs, jcls.has_ball)
        task = treg.make_task(name, device="cpu")
        assert isinstance(task, cls) and task.device.type == "cpu"
    with pytest.raises(KeyError, match="unknown task"):
        treg.make_task("bez_swim", device="cpu")


@pytest.mark.parametrize("name", sorted(jreg.default_configs))
def test_default_configs_match_jax_field_by_field(name):
    j = dataclasses.asdict(jreg.default_configs[name]())
    t = dataclasses.asdict(treg.default_configs[name]())
    # The switch of the device kernel: Pallas on a TPU, CUDA on a card.
    assert j.pop("use_pallas") is True and t.pop("use_kernel") is True
    assert set(t) == set(j)
    for field in j:
        assert t[field] == j[field], field
    tc, jc = treg.default_configs[name](), jreg.default_configs[name]()
    assert tc.max_episode_length == jc.max_episode_length


def test_goalie_scene_is_the_box_model_without_damping():
    goalie = treg.make_task("bez_goalie", device="cpu")
    walk = treg.make_task("bez_walk", device="cpu")
    jgoalie = jreg.make_task("bez_goalie")
    np.testing.assert_array_equal(goalie.model.box_half,
                                  jgoalie.model.box_half)
    assert not goalie.cfg.stl and walk.cfg.stl
    assert goalie.scene.has_ball and not walk.scene.has_ball
    assert (goalie.base_params.kd == 0).all()
    assert float(goalie.base_params.ground_friction) == pytest.approx(0.35)
