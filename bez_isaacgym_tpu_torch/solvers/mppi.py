"""MPPI (model-predictive path integral) sampling solver.

Port of `bez_isaacgym_tpu/solvers/mppi.py`.  K perturbed action sequences
per solve are rolled out through the task's batched physics step over an
H-step horizon (a Python loop over H), scored with the task's reward, and
softmax-averaged (or the elite sample executed).  All S solves x K samples
run as ONE flattened physics batch of S*K rollouts.  On a CUDA device,
through the substep kernel and without a policy prior, the H-step rollout
is one CUDA graph per input shape, captured at its first call and replayed
after.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from bez_isaacgym_tpu_torch.ops.quat import quat_axis
from bez_isaacgym_tpu_torch.tasks.base import BezTask, EnvState, tree_map

Tensor = torch.Tensor
F32 = torch.float32

DESIRED_HEIGHT = 0.325  # kick_env.py:1125


@dataclass(frozen=True)
class MPPIConfig:
    """Field meanings as in the JAX package's MPPIConfig."""

    horizon: int = 32          # control steps per rollout
    num_samples: int = 32      # K rollouts per solve
    sigma: float = 0.15        # exploration std [rad]
    temperature: float = 0.05  # softmax temperature (lambda)
    gamma: float = 1.0         # reward discount along the horizon
    done_penalty: float = 10.0 # extra cost when a rollout terminates
    balance_weight: float = 0.0
                               # per-step stability shaping (balance_score)
    terminal_balance_weight: float = 0.0
                               # balance_score on the horizon-final state
    elite: bool = False        # execute the argmax sample instead of the
                               # softmax average
    zero_nominal_sample: bool = False
                               # sample R's noise forced to zero, so the
                               # unperturbed nominal is always scored
    recovery_samples: int = 0  # with a prior_fn + elite: the first R
                               # samples are absolute sequences around the
                               # ready stand, N(0, recovery_sigma)
    recovery_sigma: float = 0.1
    recovery_gate: float = 0.0 # recovery samples are eligible only when
                               # the pure-policy rollout's stability score
                               # falls below this gate


def balance_score(physics) -> Tensor:
    """Stability score of a batched physics state (higher = more upright):
    torso up-projection minus height error minus scaled base spin."""
    up = quat_axis(physics.base_quat, 2)[..., 2]
    height_err = torch.abs(physics.base_pos[..., 2] - DESIRED_HEIGHT)
    spin = torch.linalg.norm(physics.base_u[..., 3:6], dim=-1)
    return up - 4.0 * height_err - 0.05 * spin


class MPPIState(NamedTuple):
    """Per-solve solver state: the warm-started nominal sequence (S, H, nq).

    With a policy prior it is the residual added to the prior's actions;
    without one, the absolute action sequence.
    """

    nominal: Tensor


class _Graph(NamedTuple):
    """A captured rollout: its static inputs (in `_leaves` order, None where
    the input has no leaf) and its outputs."""

    graph: torch.cuda.CUDAGraph
    inputs: list
    total: Tensor
    stab: Tensor


def _leaves(tree) -> list:
    """The leaves of nested tuples in order, None included."""
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


class MPPISolver:
    """Batched MPC: solve(env_states, mppi_states, gen) over S solves.

    prior_fn: optional policy prior `obs (N, num_obs) -> actions (N, nq)`;
    when set, each rollout runs closed-loop around it.
    graph_replays counts the replays of the rollout's CUDA graphs (one per
    input shape, in `_graphs`).
    """

    def __init__(self, task: BezTask, cfg: MPPIConfig = MPPIConfig(),
                 prior_fn: Optional[Callable] = None):
        self.task = task
        self.cfg = cfg
        self.prior_fn = prior_fn
        self._graphs: dict = {}
        self.graph_replays = 0

    def init_state(self, num_solves: int) -> MPPIState:
        return MPPIState(nominal=torch.zeros(
            (num_solves, self.cfg.horizon, self.task.num_actions), dtype=F32,
            device=self.task.device))

    def _rollout_scores(self, env_states: EnvState, seqs: Tensor,
                        absolute: Tensor | None = None):
        """Total discounted rewards (N,) and the stability indicator (N,)
        for N flattened rollouts (`_rollout_eager`).

        On a CUDA device, through the substep kernel and without a prior,
        the rollout is replayed from a CUDA graph captured at the first call
        with the same input shapes, dtypes, device and TF32 setting.
        Otherwise the eager loop runs: a prior is the caller's code and may
        do host work, and the plain engine makes host constants per call,
        neither of which a capture allows.
        """
        if (self.prior_fn is not None or seqs.device.type != "cuda"
                or not self.task.cfg.use_kernel):
            return self._rollout_eager(env_states, seqs, absolute)
        leaves = _leaves((env_states, seqs))
        key = (seqs.device, torch.backends.cuda.matmul.allow_tf32,
               tuple(None if x is None else (x.shape, x.dtype)
                     for x in leaves))
        with torch.cuda.device(seqs.device):
            g = self._graphs.get(key)
            if g is None:
                g = self._graphs[key] = self._capture(env_states, seqs)
            for dst, src in zip(g.inputs, leaves):
                if src is not None:
                    dst.copy_(src)
            g.graph.replay()
        self.graph_replays += 1
        # Copies: the next replay writes over the graph's outputs.
        return g.total.clone(), g.stab.clone()

    def _capture(self, env_states: EnvState, seqs: Tensor) -> _Graph:
        """The rollout on static copies of its inputs, warmed up on a side
        stream and then captured.  A failed capture raises."""
        states = tree_map(torch.clone, env_states)
        seqs = seqs.clone()
        stream = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self._rollout_eager(states, seqs)
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            total, stab = self._rollout_eager(states, seqs)
        return _Graph(graph, _leaves((states, seqs)), total, stab)

    def _rollout_eager(self, env_states: EnvState, seqs: Tensor,
                       absolute: Tensor | None = None):
        """The rollout as a Python loop over the H control steps.

        seqs (N, H, nq): absolute actions, or residuals around the policy
        prior; `absolute` (N,) bool marks rollouts whose sequences are
        absolute even under a prior (the recovery family).
        """
        task, cfg = self.task, self.cfg
        N, H, na = seqs.shape
        dev = seqs.device
        max_len = task.cfg.max_episode_length
        s = env_states
        alive = torch.ones(N, dtype=torch.bool, device=dev)
        fallen = torch.zeros(N, dtype=torch.bool, device=dev)
        u_prev = torch.zeros((N, na), dtype=F32, device=dev)
        rewards = []
        for t in range(H):
            u_t = seqs[:, t]
            if self.prior_fn is not None:
                obs, s = task.observe(s, u_prev)
                prior_u = self.prior_fn(obs)
                if absolute is not None:
                    u_t = torch.where(absolute[:, None], u_t, prior_u + u_t)
                else:
                    u_t = prior_u + u_t
            u = u_t.clamp(-task.cfg.clip_actions, task.cfg.clip_actions)
            u = torch.cat([torch.zeros_like(u[:, 0:2]), u[:, 2:]], dim=-1)
            targets = torch.minimum(
                torch.maximum(u + task.default_dof_pos, task.dof_lower),
                task.dof_upper)
            physics = task._step_physics_batch(s.dyn, s.physics, targets)
            s = s._replace(physics=physics, progress=s.progress + 1)
            reward, done = task.reward_done(s, u)
            if cfg.balance_weight:
                reward = reward + cfg.balance_weight * balance_score(physics)
            reward = torch.where(alive, reward, torch.zeros_like(reward))
            terminal = alive & done & (s.progress < max_len)
            reward = reward - cfg.done_penalty * terminal.to(F32)
            fallen = fallen | (alive & (physics.base_pos[:, 2] < 0.275))
            alive = alive & ~done
            u_prev = u
            rewards.append(reward)
        disc = cfg.gamma ** torch.arange(H, dtype=F32, device=dev)
        total = torch.einsum("hn,h->n", torch.stack(rewards), disc)
        # Doom indicator for the recovery gate: the robot fell during the
        # rollout, or it is still running and ends unbalanced.
        final = balance_score(s.physics)
        stab = torch.where(fallen, torch.full_like(final, -2.0),
                           torch.where(alive, final, torch.ones_like(final)))
        if cfg.terminal_balance_weight:
            total = total + cfg.terminal_balance_weight * torch.where(
                alive, final, torch.zeros_like(final))
        return total, stab

    def solve(self, env_states: EnvState, mppi_states: MPPIState,
              gen: torch.Generator | None = None,
              noise: Tensor | None = None,
              recovery_noise: Tensor | None = None):
        """One MPC solve for S envs at once.

        env_states: batched EnvState (S); mppi_states.nominal (S, H, nq).
        The sampling noise is standard normal, drawn from `gen` unless given
        as `noise` (S, K, H, nq) (and `recovery_noise` (S, R, H, nq) when
        recovery samples are on), so a caller can feed pre-drawn noise.
        Returns (actions (S, nq), mppi_states', info).
        """
        cfg, task = self.cfg, self.task
        S, H, na = mppi_states.nominal.shape
        K = cfg.num_samples
        R = cfg.recovery_samples if self.prior_fn is not None else 0
        if R and not (cfg.elite and cfg.zero_nominal_sample):
            raise ValueError("recovery_samples requires elite + "
                             "zero_nominal_sample (the gate reads the "
                             "pure-policy rollout at sample index R)")
        dev = mppi_states.nominal.device
        if noise is None:
            noise = torch.randn((S, K, H, na), generator=gen, device=dev)
        eps = cfg.sigma * noise
        if cfg.zero_nominal_sample:
            eps = eps.clone()
            eps[:, R] = 0.0
        seqs = mppi_states.nominal[:, None] + eps        # (S,K,H,na)
        abs_flags = None
        if R:
            # Recovery family: absolute stand-biased sequences (sample 0 is
            # the pure ready stand, the rest N(0, recovery_sigma)).
            if recovery_noise is None:
                recovery_noise = torch.randn((S, R, H, na), generator=gen,
                                             device=dev)
            rec = (cfg.recovery_sigma * recovery_noise).clone()
            rec[:, 0] = 0.0
            seqs = torch.cat([rec, seqs[:, R:]], dim=1)
            abs_flags = (torch.arange(K, device=dev) < R).repeat(S)

        flat_states = tree_map(lambda x: torch.repeat_interleave(x, K, dim=0),
                               env_states)
        scores, stab = self._rollout_scores(
            flat_states, seqs.reshape(S * K, H, na), abs_flags)
        scores = scores.reshape(S, K)
        if R:
            # Recovery eligibility gate: only when the pure-policy rollout
            # (zero-residual sample at index R) is doomed may a recovery
            # plan win.
            doomed = stab.reshape(S, K)[:, R] < cfg.recovery_gate
            mask = torch.arange(K, device=dev)[None, :] < R
            scores = torch.where(mask & ~doomed[:, None],
                                 torch.full_like(scores, -torch.inf), scores)

        w = torch.softmax(scores / cfg.temperature, dim=-1)   # (S,K)
        best = torch.argmax(scores, dim=-1)                    # (S,)
        if cfg.elite:
            new_nominal = seqs[torch.arange(S, device=dev), best]
        else:
            new_nominal = torch.einsum("sk,skhj->shj", w, seqs)
        if self.prior_fn is not None:
            # nominal is a residual; the executed action is prior + residual.
            obs0, _ = task.observe(env_states,
                                   torch.zeros((S, na), dtype=F32, device=dev))
            actions = self.prior_fn(obs0) + new_nominal[:, 0]
            if R:
                # A winning recovery plan executes its absolute action and
                # resets the carried residual to zero.
                won_rec = best < R
                actions = torch.where(won_rec[:, None], new_nominal[:, 0],
                                      actions)
                new_nominal = torch.where(won_rec[:, None, None],
                                          torch.zeros_like(new_nominal),
                                          new_nominal)
        else:
            actions = new_nominal[:, 0]
        shifted = torch.cat([new_nominal[:, 1:], new_nominal[:, -1:]], dim=1)
        info = {"best_score": scores.max(dim=-1).values,
                "mean_score": scores.mean(dim=-1),
                "ess": 1.0 / torch.sum(w * w, dim=-1)}
        return actions, MPPIState(nominal=shifted), info
