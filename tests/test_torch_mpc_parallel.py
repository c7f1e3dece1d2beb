"""Data-parallel MPPI (`bez_isaacgym_tpu_torch/parallel/mpc.py`) on the
CPU: 2 spawned gloo ranks each solve their half of S = 4 walk envs (H=2,
K=2, substeps 1, the JAX package's tests/test_parallel.py configuration)
with their own generator; each rank's actions and nominal equal a
single-process `MPPISolver.solve` of its slice with that rank's generator
rebuilt (`rank_seed`), to 1e-6 absolute (the same f32 code on the same
inputs), and the gathered actions are both slices in
order on both ranks.  The same with explicit noise per rank.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import torch_dp_worker  # noqa: E402
from bez_isaacgym_tpu_torch.parallel import distributed  # noqa: E402
from bez_isaacgym_tpu_torch.parallel.mesh import rank_seed  # noqa: E402
from bez_isaacgym_tpu_torch.solvers.mppi import (MPPIConfig,  # noqa: E402
                                                 MPPISolver)
from bez_isaacgym_tpu_torch.tasks.base import TaskConfig, tree_map  # noqa
from bez_isaacgym_tpu_torch.tasks.walk import WalkTask  # noqa: E402

RANKS, S, SEED = 2, 4, 7
SL = S // RANKS


@pytest.fixture(scope="module")
def noise():
    rng = np.random.default_rng(0)
    return [torch.as_tensor(rng.standard_normal((SL, 2, 2, 18)),
                            dtype=torch.float32) for _ in range(RANKS)]


@pytest.fixture(scope="module")
def ranks(noise):
    jobs = [("own", "mpc", {"num_solves": S, "seed": SEED, "noise": None}),
            ("given", "mpc", {"num_solves": S, "seed": SEED,
                              "noise": noise})]
    return distributed.spawn_ranks(torch_dp_worker.run_jobs, RANKS, jobs)


@pytest.fixture(scope="module")
def single():
    task = WalkTask(TaskConfig(substeps=1, episode_length_s=10.0),
                    device="cpu")
    solver = MPPISolver(task, MPPIConfig(horizon=2, num_samples=2))
    envs = task.reset(torch.Generator().manual_seed(SEED), S)
    return solver, envs


@pytest.mark.parametrize("how", ["own", "given"])
def test_each_rank_equals_the_single_process_solve_of_its_slice(
        ranks, single, noise, how):
    solver, envs = single
    for r, res in enumerate(ranks):
        rows = slice(r * SL, (r + 1) * SL)
        gen = torch.Generator().manual_seed(rank_seed(SEED, r))
        act, st, _ = solver.solve(tree_map(lambda x: x[rows], envs),
                                  solver.init_state(SL), gen,
                                  noise=noise[r] if how == "given" else None)
        got = res[how]
        assert got["actions"].shape == (SL, 18)
        np.testing.assert_allclose(got["actions"].numpy(), act.numpy(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["nominal"].numpy(),
                                   st.nominal.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("how", ["own", "given"])
def test_gathered_actions_are_the_slices_in_order(ranks, how):
    glob = torch.cat([res[how]["actions"] for res in ranks])
    for res in ranks:
        assert torch.equal(res[how]["global"], glob)
    # The ranks drew different noise from their own generators.
    assert not torch.equal(ranks[0]["own"]["actions"],
                           ranks[1]["own"]["actions"])
