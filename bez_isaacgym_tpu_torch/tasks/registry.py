"""Task registry: port of `bez_isaacgym_tpu/tasks/registry.py` (reference
bez_isaacgym/tasks/__init__.py:10-16, plus the restored goalie task)."""

from __future__ import annotations

from bez_isaacgym_tpu_torch.tasks.base import BezTask, TaskConfig
from bez_isaacgym_tpu_torch.tasks.goalie import GoalieTask, goalie_config
from bez_isaacgym_tpu_torch.tasks.kick import KickTask
from bez_isaacgym_tpu_torch.tasks.orient import OrientTask, orient_config
from bez_isaacgym_tpu_torch.tasks.walk import WalkTask, walk_config

task_map: dict[str, type[BezTask]] = {
    "bez_kick": KickTask,
    "bez_walk": WalkTask,
    "bez_orient": OrientTask,
    "bez_goalie": GoalieTask,
}

default_configs = {
    "bez_kick": TaskConfig,
    "bez_walk": walk_config,
    "bez_orient": orient_config,
    "bez_goalie": goalie_config,
}


def make_task(name: str, cfg: TaskConfig | None = None,
              device="cuda") -> BezTask:
    if name not in task_map:
        raise KeyError(f"unknown task {name!r}; available: {sorted(task_map)}")
    return task_map[name](cfg, device=device)
