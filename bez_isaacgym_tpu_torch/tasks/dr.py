"""Domain-randomization engine (port of `bez_isaacgym_tpu/tasks/dr.py`).

Per-parameter gaussian-or-uniform distributions with additive/scaling
operations and linear/constant schedules, frequency gating and setup-only
properties (reference: vec_task.py:505-725, spec bez_kick.yaml:151-219).
Draws come from an explicit `torch.Generator`; a batched `step` (one
schedule position per env) broadcasts over the trailing dims of `shape`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

Tensor = torch.Tensor


@dataclass(frozen=True)
class RandSpec:
    """One randomized parameter (vec_task.py:544-618 semantics).

    range: (mu, std) for gaussian, (lo, hi) for uniform.
    operation: "additive" | "scaling" (applied to the base value).
    distribution: "gaussian" | "uniform".
    schedule: None | "linear" | "constant".
    range_correlated: extra component drawn once per randomization; (0,0)
    disables it like the reference default.
    setup_only: randomize once per env before simulation, never again.
    """

    range: tuple = (0.0, 0.0)
    operation: str = "additive"
    distribution: str = "gaussian"
    schedule: str | None = None
    schedule_steps: int = 3000
    range_correlated: tuple = (0.0, 0.0)
    setup_only: bool = False
    enabled: bool = True


def _sched_scaling(spec: RandSpec, step, device) -> Tensor:
    """vec_task.py:552-561."""
    step = torch.as_tensor(step, dtype=torch.float32, device=device)
    if spec.schedule == "linear":
        return step.clamp(max=spec.schedule_steps) / spec.schedule_steps
    if spec.schedule == "constant":
        return (step >= spec.schedule_steps).to(torch.float32)
    return torch.ones_like(step)


def _draw(gen: torch.Generator, spec: RandSpec, rng: tuple, shape, s: Tensor
          ) -> Tensor:
    """One sample for `rng` = (a, b) under the schedule scaling s."""
    a, b = float(rng[0]), float(rng[1])
    s = s.reshape(s.shape + (1,) * (len(shape) - s.dim()))
    dev = s.device
    if spec.distribution == "gaussian":
        if spec.operation == "additive":
            mu, std = a * s, b * s
        else:  # scaling: std ramps, mean interpolates to 1
            mu, std = a * s + (1.0 - s), b * s
        return mu + std * torch.randn(shape, generator=gen, device=dev)
    if spec.operation == "additive":
        lo, hi = a * s, b * s
    else:
        lo, hi = a * s + (1.0 - s), b * s + (1.0 - s)
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)


def sample(gen: torch.Generator, spec: RandSpec, shape, step,
           device=None) -> Tensor:
    """Draw the randomization variable (white + correlated components)."""
    s = _sched_scaling(spec, step, device if device is not None
                       else gen.device)
    val = _draw(gen, spec, spec.range, tuple(shape), s)
    if tuple(spec.range_correlated) != (0.0, 0.0):
        corr = _draw(gen, spec, spec.range_correlated, tuple(shape), s)
        # Scaling: the identity-centred parts add around 1, so recenter.
        val = val + corr - 1.0 if spec.operation == "scaling" else val + corr
    return val


def apply(gen: torch.Generator, spec: RandSpec, value: Tensor, step
          ) -> Tensor:
    """Randomize `value` according to spec at schedule `step`."""
    if not spec.enabled:
        return value
    r = sample(gen, spec, value.shape, step, device=value.device)
    return value * r if spec.operation == "scaling" else value + r


@dataclass(frozen=True)
class DomainRandConfig:
    """Full DR block of bez_kick.yaml:151-219 as a typed tree."""

    enabled: bool = False
    frequency: int = 600              # env steps between re-randomizations
    observations: RandSpec = field(default_factory=lambda: RandSpec(
        range=(0.0, 0.002)))
    actions: RandSpec = field(default_factory=lambda: RandSpec(
        range=(0.0, 0.02)))
    gravity: RandSpec = field(default_factory=lambda: RandSpec(
        range=(0.0, 0.4), schedule="linear"))
    body_mass: RandSpec = field(default_factory=lambda: RandSpec(
        range=(0.5, 1.5), operation="scaling", distribution="uniform",
        schedule="linear", setup_only=True))
    shape_friction: RandSpec = field(default_factory=lambda: RandSpec(
        range=(0.7, 1.3), operation="scaling", distribution="uniform",
        schedule="linear"))
    shape_restitution: RandSpec = field(default_factory=lambda: RandSpec(
        range=(0.0, 0.7), operation="scaling", distribution="uniform",
        schedule="linear"))
    dof_stiffness: RandSpec = field(default_factory=lambda: RandSpec(
        range=(0.5, 1.5), operation="scaling", distribution="uniform",
        schedule="linear"))
    dof_damping: RandSpec = field(default_factory=lambda: RandSpec(
        range=(0.5, 1.5), operation="scaling", distribution="uniform",
        schedule="linear"))
    dof_lower: RandSpec = field(default_factory=lambda: RandSpec(
        range=(0.0, 0.01), schedule="linear"))
    dof_upper: RandSpec = field(default_factory=lambda: RandSpec(
        range=(0.0, 0.01), schedule="linear"))
