"""Debug reward dashboard: the reference's live matplotlib grids, headless.

Port of `bez_isaacgym_tpu/viz/debug_rewards.py` (KickEnv's debug.rewards
instrumentation, kick_env.py:230-238, :586-722: a 2x3 grid of kick
velocity, distance kicked, goal angle difference, up-projection and the
velocity / pose penalty terms), collected per step from env 0 and written
as a PNG at the end.  matplotlib is needed only by `save`.
"""

from __future__ import annotations

import numpy as np
import torch

from bez_isaacgym_tpu_torch.ops.quat import get_basis_vector
from bez_isaacgym_tpu_torch.viz.render import require_matplotlib


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64)


class KickRewardDebugger:
    """Accumulate per-step kick reward components (env 0) and plot them."""

    FIELDS = ("kick_velocity", "distance_kicked", "goal_angle_diff",
              "up_proj", "vel_reward", "pos_reward")

    def __init__(self, task):
        self.task = task
        self.history = {f: [] for f in self.FIELDS}
        self.t = []

    def record(self, state) -> None:
        """state: batched EnvState; samples env 0 (kick_env.py:630-638)."""
        ph = state.physics
        i = 0
        ball_xy = _np(ph.ball_pos[i, :2])
        ball_init = _np(state.ball_init[i])
        goal = _np(state.goal[i])
        progress = int(state.progress[i])
        dt = self.task.cfg.dt
        dist_kicked = float(np.linalg.norm(ball_xy - ball_init))
        t = max(progress * dt, dt)

        to_goal = goal - ball_xy
        ball_angle = np.arctan2(to_goal[1], to_goal[0])
        init_angle = np.arctan2(goal[1] - ball_init[1], goal[0] - ball_init[0])

        up = _np(get_basis_vector(ph.base_quat[i], torch.tensor(
            [0.0, 0.0, 1.0], dtype=torch.float32, device=ph.base_quat.device)))
        v = _np(ph.base_u[i, :3])
        w = _np(ph.base_u[i, 3:6])
        q = _np(ph.q[i])
        default = _np(self.task.default_dof_pos)

        self.t.append(progress)
        self.history["kick_velocity"].append(dist_kicked / t)
        self.history["distance_kicked"].append(dist_kicked)
        self.history["goal_angle_diff"].append(abs(init_angle - ball_angle))
        self.history["up_proj"].append(float(up[2]))
        self.history["vel_reward"].append(
            0.05 * float(np.linalg.norm(np.concatenate([v, w]))))
        self.history["pos_reward"].append(
            0.05 * float(np.linalg.norm(default - q)))

    def save(self, path: str) -> str:
        require_matplotlib()
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 3, figsize=(12, 6), tight_layout=True)
        for ax, field in zip(axes.ravel(), self.FIELDS):
            ax.plot(self.t, self.history[field])
            ax.set_title(field)
            ax.set_xlabel("step")
            ax.grid(True, alpha=0.3)
        fig.savefig(path, dpi=100)
        plt.close(fig)
        return path
