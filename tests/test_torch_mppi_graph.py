"""CUDA-only checks of the MPPI rollout's CUDA graph; they skip without a
CUDA device.

The graph replays what the eager loop computes (`_rollout_eager`), from
fresh inputs on every solve, launches the substep kernel H x substeps
times on every replay (counted in the device trace), and is captured once
per input shape.  Run on the GPU with
    python -m pytest --noconftest -m cuda tests/test_torch_mppi_graph.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from bez_isaacgym_tpu_torch.ops import substep as ss  # noqa: E402
from bez_isaacgym_tpu_torch.solvers.mppi import (MPPIConfig, MPPISolver,  # noqa: E402
                                                 MPPIState)
from bez_isaacgym_tpu_torch.tasks.base import TaskConfig, tree_map  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.kick import KickTask  # noqa: E402
from bez_isaacgym_tpu_torch.utils.profiling import kernel_launches  # noqa: E402

pytestmark = pytest.mark.cuda

S, K, H, SUBSTEPS = 2, 4, 4, 2      # 8 rollouts of 4 control steps
CFG = MPPIConfig(horizon=H, num_samples=K)


@pytest.fixture
def task():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return KickTask(TaskConfig(substeps=SUBSTEPS), device="cuda")


def inputs(task, seed, n=S):
    """n reset envs, a random nominal and noise, all from `seed`."""
    g = torch.Generator(device=task.device).manual_seed(seed)
    na = task.num_actions
    env = task.reset(g, n)
    nominal = 0.1 * torch.randn((n, H, na), generator=g, device=task.device)
    noise = torch.randn((n, K, H, na), generator=g, device=task.device)
    return env, MPPIState(nominal=nominal), noise


def eager_solver(solver):
    """A solver like `solver` whose rollout is always the eager loop."""
    eager = MPPISolver(solver.task, solver.cfg, prior_fn=solver.prior_fn)
    eager._rollout_scores = eager._rollout_eager
    return eager


def assert_same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y), float((x - y).abs().max())


def test_graph_equals_the_eager_loop(task):
    """Three solves from different states and noise: the replayed rollout's
    scores and the solve's outputs equal the eager loop's, bit for bit (a
    replay from stale static inputs would not)."""
    solver = MPPISolver(task, CFG)
    eager = eager_solver(solver)
    na = task.num_actions
    for seed in (1, 2, 3):
        env, st, noise = inputs(task, seed)
        flat = tree_map(lambda x: x.repeat_interleave(K, dim=0), env)
        seqs = (st.nominal[:, None] + CFG.sigma * noise).reshape(S * K, H, na)
        assert_same(solver._rollout_scores(flat, seqs),
                    solver._rollout_eager(flat, seqs))
        a, m, info = solver.solve(env, st, noise=noise)
        a_e, m_e, info_e = eager.solve(env, st, noise=noise)
        assert_same((a, m.nominal, info["best_score"], info["mean_score"]),
                    (a_e, m_e.nominal, info_e["best_score"],
                     info_e["mean_score"]))
    assert len(solver._graphs) == 1 and solver.graph_replays == 6


def test_replay_launches_the_kernel_and_captures_once_per_shape(task):
    """The substep kernels in the device trace of each solve: the replay's
    H x substeps, and on a shape's first solve the eager warm-up's as many
    again, which alone are launched from Python (the capture launches
    nothing)."""
    solver = MPPISolver(task, CFG)
    for i, (seed, n) in enumerate(((1, S), (2, S), (3, S), (4, S + 1))):
        env, st, noise = inputs(task, seed, n)
        first = i in (0, 3)
        before = ss.substep.launches
        _, traced = kernel_launches(lambda: solver.solve(env, st, noise=noise),
                                    "bez_substep_kernel")
        assert traced == (2 if first else 1) * H * SUBSTEPS, (i, traced)
        assert ss.substep.launches - before == (H * SUBSTEPS if first else 0)
        assert solver.graph_replays == i + 1
        assert len(solver._graphs) == (1 if n == S else 2)


def test_prior_solver_captures_nothing(task):
    w = 0.01 * torch.randn((task.num_obs, task.num_actions),
                           generator=torch.Generator(device="cuda")
                           .manual_seed(11), device="cuda")
    solver = MPPISolver(task, CFG, prior_fn=lambda obs: obs @ w)
    env, st, noise = inputs(task, 5)
    before = ss.substep.launches
    (a, m, _), traced = kernel_launches(
        lambda: solver.solve(env, st, noise=noise), "bez_substep_kernel")
    assert traced == ss.substep.launches - before == H * SUBSTEPS
    a_e, m_e, _ = eager_solver(solver).solve(env, st, noise=noise)
    assert_same((a, m.nominal), (a_e, m_e.nominal))
    assert not solver._graphs and solver.graph_replays == 0
