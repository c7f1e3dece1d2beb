"""Typed config tree + CLI overrides.

Port of `bez_isaacgym_tpu/utils/config.py`: one dataclass tree and
`key=value` dotted overrides in place of the reference's Hydra/OmegaConf
stack (cfg/config.yaml, train.py:53-58), with the same keys and defaults
over the port's PPOConfig, TaskConfig and task registry, plus `device`.

Examples:
    python -m bez_isaacgym_tpu_torch.train task=bez_kick num_envs=4096 seed=7
    python -m bez_isaacgym_tpu_torch.train task=bez_walk train.horizon=16 \\
        task_cfg.dr.enabled=True
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any

import torch

from bez_isaacgym_tpu_torch import resolve_device
from bez_isaacgym_tpu_torch.parallel.distributed import under_torchrun
from bez_isaacgym_tpu_torch.rl.ppo import PPOConfig
from bez_isaacgym_tpu_torch.tasks.base import TaskConfig
from bez_isaacgym_tpu_torch.tasks.registry import default_configs


def launch_message(n_cards: int) -> str:
    """What to do when multi_chip finds several cards but one process."""
    return (f"multi_chip=True with {n_cards} visible CUDA devices needs one "
            f"process per card: launch with `torchrun --nproc-per-node "
            f"{n_cards} -m bez_isaacgym_tpu_torch.train ...` (data-parallel "
            f"PPO over torch.distributed), or pass multi_chip=False to run "
            f"on one card")


@dataclass
class RunConfig:
    """Top-level run config (cfg/config.yaml parity)."""

    task: str = "bez_kick"            # config.yaml:46-49
    num_envs: int = 4096              # bez_kick.yaml:8
    seed: int = 42                    # config.yaml:10
    test: bool = False                # config.yaml:36
    checkpoint: str = ""              # config.yaml:38
    max_iterations: int = 100000      # bez_kickPPO.yaml:64
    experiment: str = ""              # config.yaml:7
    output_dir: str = "runs"
    save_frequency: int = 100         # bez_kickPPO.yaml:66
    save_best_after: int = 100        # bez_kickPPO.yaml:65
    log_frequency: int = 10
    multi_chip: bool = True           # under torchrun: data-parallel
                                      # over the ranks; with several
                                      # cards and one process it raises
    play_steps: int = 600             # play: eval loop length
    render: str = ""                  # play: "live" streams a viewer,
                                      # a path writes env 0's episode
    device: str = "cuda"              # "cpu" for tiny runs on the CPU
    train: PPOConfig = field(default_factory=PPOConfig)
    task_cfg: TaskConfig | None = None

    def resolved_task_cfg(self) -> TaskConfig:
        if self.task_cfg is not None:
            return self.task_cfg
        if self.task not in default_configs:
            raise KeyError(f"unknown task {self.task!r}; "
                           f"available: {sorted(default_configs)}")
        return default_configs[self.task]()

    @property
    def name(self) -> str:
        return self.experiment or \
            f"Bez_{self.task.split('_', 1)[-1].capitalize()}"


def run_device(cfg: RunConfig) -> torch.device:
    """The run's device; raises without a card when it is CUDA, and when
    multi_chip finds more than one card in a process not started by
    torchrun (no quiet single-card run)."""
    dev = resolve_device(cfg.device)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if cfg.multi_chip and n_cards > 1 and not under_torchrun():
        raise RuntimeError(launch_message(n_cards))
    return dev


_BOOL = {"true": True, "false": False, "1": True, "0": False,
         "yes": True, "no": False}


def _convert(value: str, current: Any) -> Any:
    if isinstance(current, bool):
        return _BOOL[value.lower()]
    if isinstance(current, int) and not isinstance(current, bool):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        parts = json.loads(value) if value.startswith("[") \
            else value.split(",")
        return tuple(type(current[0])(p) for p in parts) if current \
            else tuple(parts)
    return value


def _set_dotted(obj: Any, path: list[str], value: str) -> Any:
    """Immutably set a dotted field on a (nested) dataclass."""
    name = path[0]
    if not hasattr(obj, name):
        raise KeyError(f"unknown config key {name!r} on {type(obj).__name__}")
    current = getattr(obj, name)
    if len(path) == 1:
        new = _convert(value, current)
    else:
        new = _set_dotted(current, path[1:], value)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{name: new})
    raise TypeError(f"cannot set {name} on non-dataclass {obj!r}")


def parse_overrides(argv: list[str], cfg: RunConfig | None = None
                    ) -> RunConfig:
    """Apply `key=value` dotted overrides.

    task_cfg.* overrides are applied last, against the *selected task's*
    default config (not a bare TaskConfig), so
    `task=bez_walk task_cfg.dr.enabled=True` keeps walk's episode length,
    goal, and asset settings.
    """
    cfg = cfg or RunConfig()
    deferred: list[tuple[str, str]] = []
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"expected key=value, got {arg!r}")
        key, value = arg.split("=", 1)
        # train.* maps into PPOConfig, task_cfg.* into TaskConfig.
        if key.split(".")[0] == "task_cfg" and len(key.split(".")) > 1:
            deferred.append((key, value))
            continue
        cfg = _set_dotted(cfg, key.split("."), value)
    if deferred and cfg.task_cfg is None:
        cfg = dataclasses.replace(cfg, task_cfg=cfg.resolved_task_cfg())
    for key, value in deferred:
        cfg = _set_dotted(cfg, key.split("."), value)
    return cfg


def pretty(cfg: Any, indent: int = 0) -> str:
    """Readable dump (utils/reformat.py:42-53 parity)."""
    lines = []
    pad = "  " * indent
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            lines.append(f"{pad}{f.name}:")
            lines.append(pretty(v, indent + 1))
        else:
            lines.append(f"{pad}{f.name}: {v}")
    return "\n".join(lines)
