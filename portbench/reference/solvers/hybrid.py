"""Hybrid sampling + SQP solver (the north-star MPC engine).

Frozen copy of the port's `solvers/hybrid.py` at commit 391cc8b (see
`portbench/reference/__init__.py`).  MPPI explores globally
(which foot, when to strike); the SQP/iLQR stage polishes its nominal with
gradient information, and the polished sequence seeds the next MPPI solve.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.solvers.mppi import (MPPIConfig, MPPISolver,
                                                 MPPIState)
from portbench.reference.solvers.sqp import SQPConfig, SQPSolver, SQPState
from portbench.reference.tasks.base import BezTask, EnvState

Tensor = torch.Tensor


class HybridState(NamedTuple):
    mppi: MPPIState
    sqp: SQPState


class HybridSolver:

    def __init__(self, task: BezTask, mppi_cfg: MPPIConfig | None = None,
                 sqp_cfg: SQPConfig | None = None, use_sqp: bool = True,
                 prior_fn=None):
        mppi_cfg = mppi_cfg or MPPIConfig()
        sqp_cfg = sqp_cfg or SQPConfig(horizon=mppi_cfg.horizon)
        if sqp_cfg.horizon != mppi_cfg.horizon:
            raise ValueError(f"SQP horizon {sqp_cfg.horizon} != MPPI horizon "
                             f"{mppi_cfg.horizon}")
        if prior_fn is not None and use_sqp:
            # With a policy prior MPPI's nominal is a closed-loop residual;
            # there is no absolute open-loop sequence for the SQP to polish.
            raise ValueError("policy prior_fn is MPPI-only; set use_sqp=False")
        self.task = task
        self.mppi = MPPISolver(task, mppi_cfg, prior_fn=prior_fn)
        self.sqp = SQPSolver(task, sqp_cfg)
        self.use_sqp = use_sqp

    def init_state(self, num_solves: int) -> HybridState:
        return HybridState(mppi=self.mppi.init_state(num_solves),
                           sqp=self.sqp.init_state(num_solves))

    def warm_start(self, state: HybridState, nominal: Tensor) -> HybridState:
        """Seed both stages with an (S, H, nu) reference action sequence."""
        return HybridState(mppi=MPPIState(nominal=nominal),
                           sqp=SQPState(nominal=nominal))

    def solve(self, env_states: EnvState, state: HybridState,
              gen: torch.Generator | None = None,
              noise: Tensor | None = None):
        """MPPI, then the SQP polish of its nominal.  `noise` (S, K, H, nu)
        replaces MPPI's draw from `gen`."""
        _, mppi_state, info = self.mppi.solve(env_states, state.mppi, gen,
                                              noise=noise)
        if not self.use_sqp:
            return (mppi_state.nominal[:, 0],
                    HybridState(mppi=mppi_state, sqp=state.sqp), info)
        actions, sqp_state, sqp_info = self.sqp.solve(
            env_states, SQPState(nominal=mppi_state.nominal))
        info = {**info, **sqp_info}
        # The polished sequence is next round's sampling nominal.
        new_state = HybridState(mppi=MPPIState(nominal=sqp_state.nominal),
                                sqp=sqp_state)
        return actions, new_state, info
