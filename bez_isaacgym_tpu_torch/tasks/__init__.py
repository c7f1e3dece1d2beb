"""Batched task library: kick / walk / orient / goalie, their base
machinery and domain randomization (port of `bez_isaacgym_tpu/tasks/`)."""

from bez_isaacgym_tpu_torch.tasks.registry import make_task, task_map  # noqa: F401
