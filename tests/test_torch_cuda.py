"""CUDA-only checks of the substep kernel; they skip without a CUDA device.

Run on the GPU with
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
(`--noconftest`: tests/conftest.py imports JAX, which the port's GPU
machine need not have).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from bez_isaacgym_tpu_torch.models import bez  # noqa: E402
from bez_isaacgym_tpu_torch.ops import engine  # noqa: E402
from bez_isaacgym_tpu_torch.ops import substep as ss  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.base import TaskConfig  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.kick import KickTask  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _buffers(model, cfg, B, dev, kick=False):
    """States around the ready pose; kick: the ball against the left leg's
    boxes and random joint, base and ball velocities."""
    rng = np.random.default_rng(B)
    q0 = bez.pose_vector(model, bez.READY_JOINT_ANGLES)
    q = torch.tensor(q0[None] + rng.uniform(-0.1, 0.1, (B, 18)),
                     dtype=torch.float32, device=dev)
    kw = {"ball_pos": (0.1, 0.05, 0.085)} if kick else {}
    st = engine.default_state(model, cfg, q, (0, 0, 0.33), (0, 0, 0, 1),
                              **kw)
    if kick:
        def draw(lo, shape):
            return torch.tensor(rng.uniform(-lo, lo, shape),
                                dtype=torch.float32, device=dev)
        st = st._replace(qd=draw(0.5, (B, 18)), base_u=draw(0.3, (B, 6)),
                         ball_vel=draw(1.0, (B, 3)))
    tg = torch.as_tensor(q0, dtype=torch.float32, device=dev).expand(B, 18)
    return (ss.pack_state(st),
            ss.pack_params(model, bez.default_dyn_params(model),
                           tg.contiguous()))


@pytest.mark.parametrize("B", [512, 1000])
@pytest.mark.parametrize("variant", ["stl", "box", "box_sensor",
                                     "stl_sensor"])
def test_kernel_matches_plain(cuda, variant, B):
    model = bez.load_bez_model(variant)
    cfg = engine.SceneConfig(substeps=2)
    tables = ss.KernelTables(model, cfg)
    x, p = _buffers(model, cfg, B, cuda)
    before = ss.substep.launches
    out = ss.substep(tables, x, p)
    torch.cuda.synchronize()
    assert ss.substep.launches == before + 1
    ref = ss.substep_plain(tables, x, p)
    n = ss.state_rows(model.nq)
    # One substep from the same inputs (f32 on both; FMA contraction and
    # summation order differ): 1e-3 on the state rows.
    assert float((out[:n] - ref[:n]).abs().max()) < 1e-3


@pytest.mark.parametrize("size", ["1", "E+1", "2048"])
def test_kernel_matches_plain_at_block_edges(cuda, size):
    """One env (a block of one warp), one env past a full block (a ragged
    block of one), and the S=64 tick's batch of 2048."""
    model = bez.load_bez_model("stl")
    cfg = engine.SceneConfig(substeps=2)
    tables = ss.KernelTables(model, cfg)
    E = ss.launch_config(tables).envs_per_block
    B = {"1": 1, "E+1": E + 1, "2048": 2048}[size]
    x, p = _buffers(model, cfg, B, cuda, kick=True)
    out = ss.substep(tables, x, p)
    ref = ss.substep_plain(tables, x, p)
    n = ss.state_rows(model.nq)
    assert torch.isfinite(out).all()
    # The bar of test_kernel_matches_plain.
    assert float((out[:n] - ref[:n]).abs().max()) < 1e-3


def test_kernel_matches_plain_with_the_ball_against_the_leg(cuda):
    model = bez.load_bez_model("stl")
    cfg = engine.SceneConfig(substeps=2)
    tables = ss.KernelTables(model, cfg)
    x, p = _buffers(model, cfg, 1024, cuda, kick=True)
    assert ss.contact_activity(tables, x).box.sum() > 0
    out = ss.substep(tables, x, p)
    ref = ss.substep_plain(tables, x, p)
    n = ss.state_rows(model.nq)
    # The bar of test_kernel_matches_plain, now with ball-box forces, the
    # ball's spin and every velocity nonzero.
    assert float((out[:n] - ref[:n]).abs().max()) < 1e-3


def test_task_on_cuda_steps_through_the_kernel(cuda):
    task = KickTask(TaskConfig(substeps=2), device="cuda")
    assert hasattr(task._step_physics_batch, "tables")
    gen = torch.Generator(device=cuda).manual_seed(0)
    env = task.reset(gen, 8)
    before = ss.substep.launches
    out = task.step_batch(env, torch.zeros((8, 18), device=cuda), gen)
    torch.cuda.synchronize()
    assert ss.substep.launches == before + 2
    assert torch.isfinite(out.obs).all()


def test_kernel_matches_plain_at_substeps_4(cuda):
    """The serving path's configuration: substeps=4 (h = dt/4), the ball
    against the leg, at the prior eval's rollout batch 64*40."""
    model = bez.load_bez_model("stl")
    cfg = engine.SceneConfig(substeps=4)
    tables = ss.KernelTables(model, cfg)
    x, p = _buffers(model, cfg, 2560, cuda, kick=True)
    out = ss.substep(tables, x, p)
    ref = ss.substep_plain(tables, x, p)
    n = ss.state_rows(model.nq)
    assert torch.isfinite(out).all()
    # The bar of test_kernel_matches_plain.
    assert float((out[:n] - ref[:n]).abs().max()) < 1e-3


def test_player_on_cuda_matches_the_player_on_the_cpu(cuda):
    from pathlib import Path

    from bez_isaacgym_tpu_torch.rl.players import PpoPlayerContinuous

    ckpt = str(Path(__file__).resolve().parents[1] / "runs" / "Bez_Kick"
               / "Bez_Kick_best.ckpt")
    task = KickTask(TaskConfig(substeps=4), device="cpu")
    on_cpu = PpoPlayerContinuous(task, checkpoint_path=ckpt, device="cpu")
    on_card = PpoPlayerContinuous(task, checkpoint_path=ckpt, device="cuda")
    rms = on_cpu.obs_rms
    obs = rms.mean + 2.0 * torch.sqrt(rms.var) * torch.randn(
        (64, 54), generator=torch.Generator().manual_seed(0))
    a_cpu = on_cpu.get_action(obs)
    a_card = on_card.get_action(obs.to(cuda))
    assert a_card.device.type == "cuda"
    # One f32 MLP on two devices (TF32 off): 1e-5.
    assert float((a_card.cpu() - a_cpu).abs().max()) <= 1e-5


@pytest.mark.parametrize("B", [1, 64, 2048])
def test_kernel_matches_plain_without_the_ball(cuda, B):
    """The walk and orient scenes (has_ball=False, substeps=4): the state
    rows at phase 1's bar, the ball's rows copied through unchanged."""
    from bez_isaacgym_tpu_torch.tasks.walk import WalkTask

    task = WalkTask(device="cuda")
    tables = task._step_physics_batch.tables
    assert not tables.cfg.has_ball
    gen = torch.Generator(device=cuda).manual_seed(B)
    env = task.reset(gen, B)
    _, tg = task._pre_physics(
        env, 0.2 * torch.randn((B, 18), generator=gen, device=cuda), gen)
    x = ss.pack_state(env.physics)
    p = ss.pack_params(task.model, env.dyn, tg)
    out = ss.substep(tables, x, p)
    ref = ss.substep_plain(tables, x, p)
    n = ss.state_rows(task.model.nq)
    assert float((out[:n] - ref[:n]).abs().max()) < 1e-3
    ball = slice(2 * task.model.nq + 13, n)
    assert torch.equal(out[ball], x[ball]) and torch.equal(ref[ball], x[ball])


@pytest.mark.parametrize("B", [1, 64])
def test_kernel_matches_plain_on_the_goalie_shot(cuda, B):
    """The goalie's box model, Kd = 0, the 10 m/s shot: one substep at a
    time through the ball's arrival (20 control steps, 80 substeps), each
    from the kernel's own state; the ball meets a box.  The bar is 1e-3,
    or twice the plain version's own f32 error against f64 on the same
    substep where that is larger (the first substep's ground impulse on
    the box feet leaves f32 errors near 1e-3 in the plain version)."""
    from bez_isaacgym_tpu_torch.tasks.goalie import GoalieTask

    task = GoalieTask(device="cuda")
    tables = task._step_physics_batch.tables
    gen = torch.Generator(device=cuda).manual_seed(B)
    env = task.reset(gen, B)
    _, tg = task._pre_physics(env, torch.zeros((B, 18), device=cuda), gen)
    x = ss.pack_state(env.physics)
    p = ss.pack_params(task.model, env.dyn, tg)
    n = ss.state_rows(task.model.nq)
    hits = 0
    for _ in range(20 * task.cfg.substeps):
        hits += int(ss.contact_activity(tables, x).box.sum())
        out = ss.substep(tables, x, p)
        ref = ss.substep_plain(tables, x, p)
        ref64 = ss.substep_plain(tables, x.double(), p.double())
        floor = float((ref[:n].double() - ref64[:n]).abs().max())
        assert float((out[:n] - ref[:n]).abs().max()) <= max(1e-3,
                                                             2 * floor)
        x = out[:n]
    assert hits > 0


@pytest.mark.parametrize("params", ["nominal", "dr"])
def test_kernel_matches_plain_at_the_training_batch(cuda, params):
    """Training's batch: B=4096, substeps 4, the kick task's reset states
    with the ball; on nominal params, and on params the DR sampler draws
    at Bez_Kick_DR's config past the linear schedules' ramp (per-env mass,
    friction, restitution, gravity, kp/kd, joint limits at full width).
    One substep at test_kernel_matches_plain's bar, five control steps at
    the bars chip_smoke.py holds the kernel to (tests/test_pallas.py's)."""
    from bez_isaacgym_tpu_torch.tasks.dr import DomainRandConfig

    task = KickTask(TaskConfig(substeps=4, dr=DomainRandConfig(
        enabled=params == "dr")), device="cuda")
    tables = task._step_physics_batch.tables
    gen = torch.Generator(device=cuda).manual_seed(110)
    B = 4096
    env = task.reset(gen, B, dr_step=3000 if params == "dr" else 0)
    if params == "dr":
        assert float(env.dyn.mass_scale.min()) < 0.55
        assert float(env.dyn.mass_scale.max()) > 1.45
    _, tg = task._pre_physics(
        env, 0.3 * torch.randn((B, 18), generator=gen, device=cuda), gen)
    x = ss.pack_state(env.physics)
    p = ss.pack_params(task.model, env.dyn, tg)
    before = ss.substep.launches
    out = ss.substep(tables, x, p)
    torch.cuda.synchronize()
    assert ss.substep.launches == before + 1
    ref = ss.substep_plain(tables, x, p)
    n = ss.state_rows(task.model.nq)
    assert torch.isfinite(out).all()
    assert float((out[:n] - ref[:n]).abs().max()) < 1e-3
    kstep = ss.make_kernel_step_fn(task.model, task.scene)
    pstep = engine.make_batched_step_fn(task.model, task.scene)
    a = b = env.physics
    for _ in range(5):
        a, b = kstep(env.dyn, a, tg), pstep(env.dyn, b, tg)
    for f, bar in (("q", 2e-3), ("base_pos", 2e-3), ("base_quat", 5e-3),
                   ("ball_pos", 1e-3)):
        assert float((getattr(a, f) - getattr(b, f)).abs().max()) <= bar, f


def test_ppo_iteration_launches_the_kernel_for_every_substep(cuda, tmp_path):
    """A PPO iteration on the card (64 envs, horizon 4, substeps 2, the
    plain engine forbidden) launches the kernel substeps x horizon times,
    and an LSTM one likewise."""
    from bez_isaacgym_tpu_torch.rl.runner import Runner
    from bez_isaacgym_tpu_torch.utils.config import parse_overrides

    def forbidden(*a, **k):
        raise AssertionError("the plain engine ran")

    real = engine.substep
    engine.substep = forbidden
    try:
        for extra in ([], ["train.rnn_units=16", "train.seq_len=2"]):
            runner = Runner(parse_overrides([
                "num_envs=64", "train.horizon=4", "train.minibatch_size=64",
                "train.mini_epochs=2", "train.units=[32,32]",
                "task_cfg.substeps=2", f"output_dir={tmp_path}", *extra]))
            before = ss.substep.launches
            runner.train(2)
            torch.cuda.synchronize()
            assert ss.substep.launches - before == 2 * 4 * 2
    finally:
        engine.substep = real


@pytest.mark.parametrize("substeps", [1, 4])
def test_struct_linearization_on_the_card_matches_the_cpu(cuda, substeps):
    """The SQP's struct linearization (plain engine under torch.func) on
    the card against the same call on the CPU, from kick reset states:
    test_solvers.py's bars, atol 1e-4, rtol 1e-3."""
    from bez_isaacgym_tpu_torch.solvers.sqp import (SQPConfig, SQPSolver,
                                                    flatten_physics)
    from bez_isaacgym_tpu_torch.tasks.base import tree_map

    tc = KickTask(TaskConfig(substeps=substeps), device=cuda)
    tp = KickTask(TaskConfig(substeps=substeps), device="cpu")
    ec = tc.reset(torch.Generator(device=cuda).manual_seed(0), 2)
    ep = tree_map(lambda v: v.cpu(), ec)
    u = 0.05 * torch.sin(torch.arange(18.0)).expand(2, 18)
    Ac, Bc = SQPSolver(tc, SQPConfig()).linearize_dynamics(
        ec, flatten_physics(ec.physics), u.to(cuda))
    Ap, Bp = SQPSolver(tp, SQPConfig()).linearize_dynamics(
        ep, flatten_physics(ep.physics), u)
    assert torch.isfinite(Ac).all() and torch.isfinite(Bc).all()
    torch.testing.assert_close(Ac.cpu(), Ap, atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(Bc.cpu(), Bp, atol=1e-4, rtol=1e-3)


def test_sqp_solve_launches_the_kernel_for_every_rollout_substep(cuda):
    """One iteration: the nominal rollout and the batched line search, H
    control steps each, every substep one kernel launch: substeps x 2H."""
    from bez_isaacgym_tpu_torch.solvers.sqp import SQPConfig, SQPSolver

    task = KickTask(TaskConfig(substeps=2), device=cuda)
    assert hasattr(task._step_physics_batch, "tables")
    env = task.reset(torch.Generator(device=cuda).manual_seed(0), 4)
    H = 4
    solver = SQPSolver(task, SQPConfig(horizon=H, iterations=1))
    real = engine.substep

    def forbidden(*a, **k):
        raise AssertionError("a forward rollout took the plain engine")

    engine.substep = forbidden
    try:
        ss.substep.launches = 0
        actions, state, info = solver.solve(env, solver.init_state(4))
        torch.cuda.synchronize()
        assert ss.substep.launches == 2 * 2 * H, ss.substep.launches
    finally:
        engine.substep = real
    assert actions.shape == (4, 18) and torch.isfinite(info["cost"]).all()


def test_dryrun_multichip_two_ranks_on_cuda(cuda):
    """One data-parallel PPO iteration over 2 spawned ranks on the card
    (gloo when they share one card, NCCL with a card each): finite
    metrics, bit-identical train states."""
    from bez_isaacgym_tpu_torch.ops import _build
    from bez_isaacgym_tpu_torch.parallel.dryrun import dryrun_multichip

    _build.load()   # built here, so the ranks only load it
    metrics = dryrun_multichip(2, "cuda")
    assert np.isfinite(list(metrics.values())).all()
