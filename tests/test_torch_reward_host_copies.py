"""The kick and orient rewards make no tensor from host data, so that the MPPI
rollout around them can be captured in a CUDA graph (a copy from pageable
host memory is refused while a stream captures).  On the CPU, the MPPI
rollout is the eager loop and captures nothing.
"""

from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from bez_isaacgym_tpu_torch.solvers.mppi import MPPIConfig, MPPISolver  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.base import TaskConfig  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.kick import KickTask  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.orient import (OrientTask,  # noqa: E402
                                                 orient_config)

TASKS = {"kick": lambda: KickTask(TaskConfig(substeps=1), device="cpu"),
         "orient": lambda: OrientTask(replace(orient_config(), substeps=1),
                                      device="cpu")}


@pytest.mark.parametrize("name", list(TASKS))
def test_reward_done_makes_no_tensor_from_host_data(name, monkeypatch):
    task = TASKS[name]()
    state = task.reset(torch.Generator().manual_seed(6), 4)
    action = torch.zeros((4, task.num_actions))

    def refuse(*a, **k):
        raise AssertionError(f"{name} reward_done made a tensor from host "
                             "data")

    monkeypatch.setattr(torch, "as_tensor", refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    reward, done = task.reward_done(state, action)
    monkeypatch.undo()
    assert reward.shape == (4,) and done.shape == (4,)


def test_cpu_rollout_is_the_eager_loop():
    task = KickTask(TaskConfig(substeps=1), device="cpu")
    solver = MPPISolver(task, MPPIConfig(horizon=2, num_samples=2))
    env = task.reset(torch.Generator().manual_seed(7), 2)
    seqs = 0.1 * torch.randn((2, 2, task.num_actions),
                             generator=torch.Generator().manual_seed(8))
    total, stab = solver._rollout_scores(env, seqs)
    want_total, want_stab = solver._rollout_eager(env, seqs)
    assert torch.equal(total, want_total) and torch.equal(stab, want_stab)
    assert not solver._graphs and solver.graph_replays == 0
