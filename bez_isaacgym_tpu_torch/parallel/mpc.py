"""Data-parallel MPC: the solve axis sharded over the ranks (port of
`bez_isaacgym_tpu/parallel/mpc.py`).

Each rank runs its slice of the S independent MPC problems (a physics
batch of S/world x K rollouts through the substep kernel) with its own
generator, so the only cross-rank traffic is gathering the actions when a
caller wants the global ones.
"""

from __future__ import annotations

from bez_isaacgym_tpu_torch.parallel.mesh import Mesh, gather_env


class DataParallelMPC:
    """`solve(env_states, solver_states, gen, noise=None)` on this rank's
    shard of the solves -> (actions, solver_states, info), all this
    rank's; `gen` is the rank's generator (`parallel/mesh.py::rank_generator`).
    `gather(actions)` returns the global (S, nq) actions on every rank."""

    def __init__(self, solver, mesh: Mesh):
        self.solver = solver
        self.mesh = mesh

    def __call__(self, env_states, solver_states, gen, noise=None):
        return self.solver.solve(env_states, solver_states, gen, noise=noise)

    def gather(self, actions):
        return gather_env(actions, self.mesh)


def data_parallel_mpc(solver, mesh: Mesh) -> DataParallelMPC:
    """The solver's solve with the leading (solve) axis sharded over
    `mesh`'s ranks, each drawing from its own generator."""
    return DataParallelMPC(solver, mesh)
