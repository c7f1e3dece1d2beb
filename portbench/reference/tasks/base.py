"""Task base: batched env machinery shared by the Bez tasks.

Port of `bez_isaacgym_tpu/tasks/base.py`.  The env axis is written out:
every EnvState field has a leading (B,) dimension, and the reference's
vectorized partial resets (kick_env.py:779-850) are a `where`-masked
substitution of freshly reset states.  Randomness comes from an explicit
`torch.Generator` where the JAX package split keys.

Ordering parity with the reference step: physics advances first, done envs
are then re-initialized, and obs/reward are computed on the post-reset state
with progress=0 (post_physics_step, kick_env.py:426-438).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from portbench.reference import resolve_device
from portbench.reference.models import bez
from portbench.reference.models.robot import DynParams, RobotModel
from portbench.reference.ops import sensors
from portbench.reference.ops.engine import (PhysicsState, SceneConfig,
                                               default_state,
                                               make_batched_step_fn)

Tensor = torch.Tensor
F32 = torch.float32


@dataclass(frozen=True)
class TaskConfig:
    """Common task knobs (cfg/task/*.yaml)."""

    episode_length_s: float = 15.0        # bez_kick.yaml:107
    clip_actions: float = 3.9             # bez_kick.yaml:11
    dt: float = 1.0 / 60.0                # bez_kick.yaml:129
    substeps: int = 4                     # ours; reference PhysX uses 2
    control_freq_inv: int = 1             # bez_kick.yaml:38
    stiffness: float = 100.0              # bez_kick.yaml:35
    damping: float = 7.5                  # bez_kick.yaml:36
    cleats: bool = False                  # bez_kick.yaml:122
    stl: bool = True                      # bez_kick.yaml:123
    plane_static_friction: float = 1.0    # bez_kick.yaml:14
    plane_restitution: float = 0.0
    bez_init_pos: tuple = (0.0, 0.0, 0.34)   # bez_kick.yaml:19
    bez_init_rot: tuple = (0.0, 0.0, 0.0, 1.0)
    ball_init_pos: tuple = (0.175, 0.0, 0.1)  # bez_kick.yaml:25
    ball_init_vel: tuple = (0.0, 0.0, 0.0)
    goal: tuple = (1.5, 0.0)              # bez_kick.yaml:31
    goal_range: float = 2.0               # walk goal box half-width
    goal_range_min: float = 0.0           # >0: sample walk goals in a ring
    win_shaping: float = 0.0              # training-only proximity bonus
    goal_angle: float = 1.5708            # bez_orient.yaml:26
    reset_dof_pos_noise: float = 0.15     # kick_env.py:786
    reset_dof_vel_noise: float = 0.1      # kick_env.py:787
    use_kernel: bool = True               # CUDA substep kernel on a CUDA
                                          # device (the CPU runs the plain
                                          # engine)

    @property
    def max_episode_length(self) -> int:
        # kick_env.py:127
        return int(self.episode_length_s / self.dt + 0.5)


class EnvState(NamedTuple):
    """Batched task state; every field has a leading env axis (B,)."""

    physics: PhysicsState
    dyn: DynParams                 # per-env (DR-randomized) dynamics params
    prev_lin_vel: Tensor           # (B,3) IMU finite-difference memory
    progress: Tensor               # (B,) int32 steps since reset
    done: Tensor                   # (B,) bool, produced by the previous step
    goal: Tensor                   # (B,2)
    goal_angle: Tensor             # (B,)
    ball_init: Tensor              # (B,2)
    dr_step: Tensor                # (B,) int32 env steps since training
                                   # start (drives DR schedules; never reset)
    ep_reward: Tensor              # (B,) cumulative unscaled episode reward
    last_rand_step: Tensor         # (B,) int32 dr_step at the last dynamics
                                   # re-randomization (DR frequency gate)


class StepOutput(NamedTuple):
    state: EnvState
    obs: Tensor
    reward: Tensor
    done: Tensor
    time_out: Tensor


def norm(x: Tensor) -> Tensor:
    """Euclidean norm over the last axis."""
    return torch.linalg.norm(x, dim=-1)


def unit(x: Tensor) -> Tensor:
    """x over its norm, the norm floored at 1e-9 (the JAX `clip(1e-9)`)."""
    return x / norm(x).clamp_min(1e-9)[..., None]


def tree_where(mask: Tensor, a, b):
    """Per-env select over (nested) NamedTuples of (B, ...) tensors."""
    if a is None:
        return None
    if isinstance(a, tuple):
        return type(a)(*[tree_where(mask, x, y) for x, y in zip(a, b)])
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def tree_map(fn, a):
    """Apply fn to every leaf but None of (nested) NamedTuples, tuples and
    dicts."""
    if a is None:
        return None
    if isinstance(a, dict):
        return {k: tree_map(fn, v) for k, v in a.items()}
    if isinstance(a, tuple):
        out = [tree_map(fn, x) for x in a]
        return type(a)(*out) if hasattr(a, "_fields") else tuple(out)
    return fn(a)


def _model_variant(cfg: TaskConfig) -> str:
    if cfg.stl:
        return "stl_sensor" if cfg.cleats else "stl"
    return "box_sensor" if cfg.cleats else "box"


class BezTask:
    """Base class: owns the static model + scene and the batched step logic.

    Subclasses define num_obs / has_ball / observe() / reward_done().
    """

    num_actions: int = bez.NUM_JOINTS
    num_obs: int = 54
    has_ball: bool = True

    def __init__(self, cfg: TaskConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        dev = self.device
        self.model: RobotModel = bez.load_bez_model(_model_variant(cfg))
        nq = self.model.nq
        self.scene = SceneConfig(dt=cfg.dt, substeps=cfg.substeps,
                                 has_ball=self.has_ball)
        p = bez.default_dyn_params(self.model,
                                   ground_friction=cfg.plane_static_friction,
                                   restitution=cfg.plane_restitution)
        self.base_params = tree_map(
            lambda x: torch.as_tensor(x, dtype=F32, device=dev),
            p._replace(kp=torch.full((nq,), cfg.stiffness),
                       kd=torch.full((nq,), cfg.damping)))
        self.default_dof_pos = torch.as_tensor(
            bez.pose_vector(self.model, bez.READY_JOINT_ANGLES), dtype=F32,
            device=dev)
        self.dof_lower = torch.as_tensor(self.model.dof_lower, dtype=F32,
                                         device=dev)
        self.dof_upper = torch.as_tensor(self.model.dof_upper, dtype=F32,
                                         device=dev)
        # The reference always steps the plain engine.
        self._step_physics_batch = make_batched_step_fn(self.model,
                                                        self.scene)
        self._foot_bodies = (self.model.body_index("left_foot"),
                             self.model.body_index("right_foot"))

    # ------------------------------------------------------------------ reset
    def _sample_dyn(self, n: int) -> DynParams:
        """Per-env dynamics: the nominal parameters (domain randomization is
        off in every configuration the benchmark runs, so the copy leaves
        it out)."""
        return tree_map(lambda x: x.expand((n,) + x.shape).clone(),
                        self.base_params)

    def reset(self, gen: torch.Generator, n: int, dr_step=0) -> EnvState:
        """n fresh env states with reference reset noise
        (kick_env.py:786-791)."""
        cfg, dev, nq = self.cfg, self.device, self.model.nq
        noise = torch.rand((n, nq), generator=gen, device=dev)
        q = self.default_dof_pos + (2 * noise - 1) * cfg.reset_dof_pos_noise
        q = torch.minimum(torch.maximum(q, self.dof_lower), self.dof_upper)
        qd = (2 * torch.rand((n, nq), generator=gen, device=dev) - 1) \
            * cfg.reset_dof_vel_noise
        physics = default_state(self.model, self.scene, q, cfg.bez_init_pos,
                                cfg.bez_init_rot, ball_pos=cfg.ball_init_pos)
        physics = physics._replace(
            qd=qd, ball_vel=torch.as_tensor(cfg.ball_init_vel, dtype=F32,
                                            device=dev).expand(n, 3).clone())
        step = torch.as_tensor(dr_step, dtype=torch.int32,
                               device=dev).expand(n).clone()

        def full(x, *shape):
            return torch.as_tensor(x, dtype=F32, device=dev).expand(
                (n,) + shape).clone()

        state = EnvState(
            physics=physics,
            dyn=self._sample_dyn(n),
            prev_lin_vel=full(0.0, 3),
            progress=torch.zeros(n, dtype=torch.int32, device=dev),
            done=torch.zeros(n, dtype=torch.bool, device=dev),
            goal=full(cfg.goal, 2),
            goal_angle=full(cfg.goal_angle),
            ball_init=full(cfg.ball_init_pos[:2], 2),
            dr_step=torch.zeros(n, dtype=torch.int32, device=dev),
            ep_reward=full(0.0),
            last_rand_step=step,
        )
        return self.task_reset(state, gen)

    def task_reset(self, state: EnvState, gen: torch.Generator) -> EnvState:
        """Task-specific goal resampling hook (walk_env.py:570-574)."""
        return state

    # ------------------------------------------------------------- step logic
    def _pre_physics(self, state: EnvState, action: Tensor,
                     gen: torch.Generator):
        """Action pipeline (vec_task.py:314-318, kick_env.py:410-419)."""
        cfg = self.cfg
        action = action.clamp(-cfg.clip_actions, cfg.clip_actions).clone()
        action[:, 0:2] = 0.0  # head motors zeroed
        targets = torch.minimum(
            torch.maximum(action + self.default_dof_pos, state.dyn.dof_lower),
            state.dyn.dof_upper)
        return action, targets

    def _post_physics(self, state: EnvState, physics: PhysicsState,
                      action: Tensor, gen: torch.Generator) -> StepOutput:
        """Auto-reset + obs + reward (post_physics_step order:
        kick_env.py:429-438)."""
        cfg = self.cfg
        n = action.shape[0]
        stepped = state._replace(physics=physics, progress=state.progress + 1,
                                 dr_step=state.dr_step + 1)
        fresh = self.reset(gen, n, stepped.dr_step)
        state2 = tree_where(state.done, fresh, stepped)
        # The DR schedule clock survives resets.
        state2 = state2._replace(dr_step=stepped.dr_step)
        obs, state3 = self.observe(state2, action)
        reward, done = self.reward_done(state3, action)
        # timeout from post-increment progress >= max (vec_task.py:331-332).
        time_out = state3.progress >= cfg.max_episode_length
        state4 = state3._replace(done=done,
                                 ep_reward=state3.ep_reward + reward)
        return StepOutput(state=state4, obs=obs, reward=reward, done=done,
                          time_out=time_out)

    def step_batch(self, states: EnvState, actions: Tensor,
                   gen: torch.Generator) -> StepOutput:
        """Batched env step: action pipeline, physics through the batched
        step (the CUDA kernel on a CUDA device), auto-reset, obs, reward."""
        actions, targets = self._pre_physics(states, actions, gen)
        physics = states.physics
        for _ in range(self.cfg.control_freq_inv):
            physics = self._step_physics_batch(states.dyn, physics, targets)
        return self._post_physics(states, physics, actions, gen)

    # ----------------------------------------------------------- observations
    def _imu_and_heading(self, state: EnvState):
        """IMU obs; the IMU link is the torso (kick_env.py:174-177)."""
        ph = state.physics
        return sensors.compute_imu(ph.base_quat, ph.base_u[:, 0:3],
                                   ph.base_u[:, 3:6], state.prev_lin_vel,
                                   self.cfg.dt)

    def _feet(self, state: EnvState) -> Tensor:
        ph = state.physics
        if self.cfg.cleats:
            return sensors.feet_sensors_cleats(ph.sensor_normal)
        lf, rf = self._foot_bodies
        return sensors.feet_sensors_no_cleats(ph.body_contact_force[:, lf],
                                              ph.body_contact_force[:, rf])

    def observe(self, state: EnvState, action) -> tuple[Tensor, EnvState]:
        raise NotImplementedError

    def reward_done(self, state: EnvState, action):
        raise NotImplementedError
