"""SQP / iLQR Gauss-Newton trajectory optimizer.

Frozen copy of the port's `solvers/sqp.py` at commit 391cc8b (see
`portbench/reference/__init__.py`): the second stage of the hybrid
MPC engine.  It refines a nominal action sequence (MPPI's, or a policy
rollout's) by linearizing the physics along the trajectory (forward-mode
autodiff through the plain engine) and running a Riccati backward pass and
a line-searched forward pass.  All S solves run in lockstep as one batch;
the line search's 4 step sizes are a further batch of 4*S rollouts.

Where the physics runs:
- Forward rollouts (the nominal rollout, the line search, `_rollout_cost`)
  call the task's batched step, `task._step_physics_batch`: in this copy
  the reference task's, which always steps the plain engine.  One call
  advances one control step in `substeps` substeps, the function the JAX
  solver scans its one-substep step `n_sub` times to compute.
- The linearization runs the plain engine's `_prepare` and `_integrate`
  under `torch.func.jvp`, with `torch.func.vmap` over the tangents only
  (the kernel has no derivative).  The SPD solve inside is
  `solve_spd_shared_factor`, whose JVP reuses the primal factor.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.func import jacfwd, jvp, vmap

from portbench.reference.ops import engine
from portbench.reference.ops import kinematics as kin
from portbench.reference.ops.engine import PhysicsState
from portbench.reference.ops.linalg import (cholesky_factor_unrolled,
                                               cholesky_substitute,
                                               solve_spd_ordered_single,
                                               solve_spd_shared_factor)
from portbench.reference.solvers.riccati import (parallel_backward,
                                                    sequential_backward)
from portbench.reference.tasks.base import BezTask, EnvState, tree_map

Tensor = torch.Tensor
F32 = torch.float32

# Flattened physics-state layout (ball quat omitted: irrelevant to costs).
_FIELDS = (("q", 18), ("qd", 18), ("base_pos", 3), ("base_quat", 4),
           ("base_u", 6), ("ball_pos", 3), ("ball_vel", 3), ("ball_ang", 3))
NX = sum(n for _, n in _FIELDS)   # 58


def flatten_physics(ph: PhysicsState) -> Tensor:
    """(..., NX): the _FIELDS of a physics state with any leading dims."""
    return torch.cat([getattr(ph, name) for name, _ in _FIELDS], dim=-1)


def unflatten_physics(x: Tensor, template: PhysicsState) -> PhysicsState:
    """x (..., NX) into `template`'s fields; the fields outside _FIELDS
    (ball quat, sensor readings) stay the template's."""
    out, i = {}, 0
    for name, n in _FIELDS:
        out[name] = x[..., i:i + n].to(F32)
        i += n
    return template._replace(**out)


@dataclass(frozen=True)
class SQPConfig:
    """Field meanings and defaults as in the JAX package's SQPConfig."""

    horizon: int = 32
    iterations: int = 3
    reg: float = 1e-3              # Levenberg-Marquardt regularization
    line_search: tuple = (1.0, 0.5, 0.25, 0.1)
    u_clip: float = 3.9
    parallel_riccati: bool = False # associative-scan backward pass
    linearize: str = "struct"      # "struct": per-substep forward mode over
                                   # the 58 state tangents (shared-factor
                                   # solve JVP) plus the closed-form
                                   # control column; "struct_z": all NX+nu
                                   # tangents through the substep;
                                   # "jacfwd": torch.func.jacfwd of the
                                   # whole step; "fd": central differences
    fd_eps: float = 1e-3           # central-difference step
    warm_reg: float = 0.0          # 0.5*warm_reg*|U - U_warmstart|^2 tether
    balance_weight: float = 0.0    # subtracts balance_weight *
                                   # balance_score(state) from the cost
    relinearize_every: int = 1     # k > 1: iterations whose index is not a
                                   # multiple of k reuse the last dynamics
                                   # linearization


class SQPState(NamedTuple):
    nominal: Tensor                # (S, H, nu)


def _repeat_rows(tree, n: int, interleave: bool):
    """Each env's row n times: interleaved (row s*n + j <- s) or tiled
    (row j*S + s <- s)."""
    if interleave:
        return tree_map(lambda v: v.repeat_interleave(n, dim=0), tree)
    return tree_map(lambda v: v.repeat((n,) + (1,) * (v.dim() - 1)), tree)


class SQPSolver:
    """Batched iLQR: solve(env_states, sqp_states) -> refined first actions."""

    def __init__(self, task: BezTask, cfg: SQPConfig = SQPConfig()):
        self.task = task
        self.cfg = cfg
        self.nu = task.num_actions
        # The linearization's unit is one substep (dt = control_dt /
        # substeps); the rollouts take whole control steps.
        self.n_sub = task.scene.substeps
        self._sub_scene = dataclasses.replace(
            task.scene, dt=task.scene.dt / self.n_sub, substeps=1)
        self._kin_mask = kin.ancestor_mask(task.model)
        self._order = engine.joints_first_order(task.model)
        self._perm = torch.as_tensor(self._order, device=task.device)
        self._iperm = torch.argsort(self._perm)

    def init_state(self, num_solves: int) -> SQPState:
        return SQPState(nominal=torch.zeros(
            (num_solves, self.cfg.horizon, self.nu), dtype=F32,
            device=self.task.device))

    # -- step and cost in flattened coordinates, batched over rows ----------
    def _targets(self, u: Tensor) -> Tensor:
        task = self.task
        uc = u.clamp(-self.cfg.u_clip, self.cfg.u_clip)
        uc = torch.cat([torch.zeros_like(uc[..., 0:2]), uc[..., 2:]], dim=-1)
        return torch.minimum(torch.maximum(uc + task.default_dof_pos,
                                           task.dof_lower), task.dof_upper)

    def _f(self, env: EnvState, x: Tensor, u: Tensor) -> Tensor:
        """One control step through the task's batched step (the plain
        engine in the reference)."""
        ph = unflatten_physics(x, env.physics)
        ph2 = self.task._step_physics_batch(env.dyn, ph, self._targets(u))
        return flatten_physics(ph2)

    def _substep_plain(self, env: EnvState, ph: PhysicsState,
                       targets: Tensor) -> PhysicsState:
        """One plain substep with the shared-factor solve (the JAX
        package's single-env `engine._substep`)."""
        task, h = self.task, self._sub_scene.dt
        H_eff, tau, aux = engine._prepare(task.model, self._sub_scene,
                                          self._kin_mask, env.dyn, ph,
                                          targets, h)
        udot = solve_spd_ordered_single(H_eff, tau, self._order)
        return engine._integrate(task.model, self._sub_scene, env.dyn, ph,
                                 udot, aux, h)

    def _f_sub(self, env: EnvState, x: Tensor, u: Tensor) -> Tensor:
        """ONE plain substep in flattened coordinates (linearization
        unit)."""
        ph = unflatten_physics(x, env.physics)
        return flatten_physics(self._substep_plain(env, ph, self._targets(u)))

    def _f_plain(self, env: EnvState, x: Tensor, u: Tensor) -> Tensor:
        """One control step on the plain engine (the oracles' function)."""
        targets = self._targets(u)
        ph = unflatten_physics(x, env.physics)
        for _ in range(self.n_sub):
            ph = self._substep_plain(env, ph, targets)
        return flatten_physics(ph)

    def _cost(self, env: EnvState, x: Tensor, u: Tensor) -> Tensor:
        ph = unflatten_physics(x, env.physics)
        reward, _ = self.task.reward_done(env._replace(physics=ph), u)
        if self.cfg.balance_weight:
            from portbench.reference.solvers.mppi import balance_score
            reward = reward + self.cfg.balance_weight * balance_score(ph)
        return -reward

    # -- linearization ------------------------------------------------------
    def linearize_dynamics(self, env: EnvState, x: Tensor, u: Tensor):
        """(A (N, NX, NX), B (N, NX, nu)): Jacobians of the control step at
        N rows (x (N, NX), u (N, nu), env states of N rows).

        cfg.linearize selects the structured forward-mode Jacobian (the
        default) or an oracle: "struct_z", "jacfwd" or "fd"."""
        cfg = self.cfg
        N = x.shape[0]
        dev = x.device
        if cfg.linearize == "struct":
            J = self._linearize_struct(env, x, u)
        elif cfg.linearize == "struct_z":
            nz = NX + self.nu
            eye_z = torch.eye(nz, dtype=F32, device=dev)[:, None].expand(
                nz, N, nz)
            J = torch.eye(NX, nz, dtype=F32, device=dev).expand(N, NX, nz)
            x_k = x
            for _ in range(self.n_sub):
                zz = torch.cat([x_k, u], dim=-1)
                y, dy = vmap(lambda v: jvp(
                    lambda w: self._f_sub(env, w[..., :NX], w[..., NX:]),
                    (zz,), (v,)), out_dims=(None, 0))(eye_z)
                Js = dy.permute(1, 2, 0)                  # (N, NX, nz)
                J = Js[..., :NX] @ J + torch.cat(
                    [torch.zeros_like(Js[..., :NX]), Js[..., NX:]], dim=-1)
                x_k = y
        elif cfg.linearize == "jacfwd":
            # Row by row; each row keeps a leading dim of 1, so matrix-vector
            # products stay batched matmuls (forward mode through an
            # unbatched `mv` under jacfwd raises a dtype error).
            def f_row(e, zz):
                e1 = tree_map(lambda v: v[None], e)
                return self._f_plain(e1, zz[None, :NX], zz[None, NX:])[0]

            J = vmap(jacfwd(f_row, argnums=1))(env, torch.cat([x, u], dim=-1))
        elif cfg.linearize == "fd":
            nz = NX + self.nu
            z = torch.cat([x, u], dim=-1)
            pert = cfg.fd_eps * torch.eye(nz, dtype=F32, device=dev)
            rep = _repeat_rows(env, nz, interleave=False)

            def f_all(zs):                       # (nz, N, nz) -> (nz, N, NX)
                zs = zs.reshape(nz * N, nz)
                return self._f_plain(rep, zs[:, :NX], zs[:, NX:]).reshape(
                    nz, N, NX)

            fp = f_all(z[None] + pert[:, None])
            fm = f_all(z[None] - pert[:, None])
            J = ((fp - fm) / (2.0 * cfg.fd_eps)).permute(1, 2, 0)
        else:
            raise ValueError(f"unknown linearize mode {cfg.linearize!r}")
        return J[..., :NX], J[..., NX:]

    def _linearize_struct(self, env: EnvState, x: Tensor, u: Tensor) -> Tensor:
        """Chain-rule composition of per-substep Jacobians:
        J_0 = [I | 0]; J_{k+1} = A_k J_k + [0 | B_k].

        A_k: one forward-mode pass of the substep over the 58 state
        tangents (primal shared, the solve's tangent reusing its factor).
        B_k: closed form.  The control enters the substep only through the
        Stable-PD torque, so dtau/du is kp on the unclipped set and
        B_k = d(integrate)/d(udot) . H^-1 S diag(kp . masks): 18
        substitutions against the same factor and a JVP of `_integrate`."""
        task, cfg = self.task, self.cfg
        model, scene = task.model, self._sub_scene
        dyn, h = env.dyn, scene.dt
        N, dev = x.shape[0], x.device
        nv = 6 + model.nq
        nu = self.nu
        eye_x = torch.eye(NX, dtype=F32, device=dev)[:, None].expand(
            NX, N, NX)
        J = torch.eye(NX, NX + nu, dtype=F32, device=dev).expand(
            N, NX, NX + nu)
        targets = self._targets(u)
        p, ip = self._perm, self._iperm

        def substep_ext(xx):
            """The substep, returning the primal pieces the control column
            needs."""
            ph = unflatten_physics(xx, env.physics)
            H_eff, tau, aux = engine._prepare(model, scene, self._kin_mask,
                                              dyn, ph, targets, h)
            Hs = 0.5 * (H_eff + H_eff.transpose(-1, -2))
            Hp = Hs[..., p, :][..., :, p]
            udot = solve_spd_shared_factor(Hp, tau[..., p])[..., ip]
            ph2 = engine._integrate(model, scene, dyn, ph, udot, aux, h)
            return flatten_physics(ph2), (Hp, udot, aux, ph)

        kp = dyn.kp.to(F32)
        kd = dyn.kd.to(F32)
        effort = dyn.effort.to(F32)
        x_k = x
        for _ in range(self.n_sub):
            y, dy, (Hp, udot, aux, ph) = vmap(
                lambda v: jvp(substep_ext, (x_k,), (v,), has_aux=True),
                out_dims=(None, 0, None))(eye_x)
            A_k = dy.permute(1, 2, 0)                     # (N, NX, NX)

            # Control column: dtau_pd/du = kp where |u| < u_clip (head rows
            # zeroed), the target inside the DOF limits and |tau_pd| below
            # the effort clamp.
            tau_pd = kp * (targets - ph.q) - (h * kp + kd) * ph.qd
            m = ((torch.abs(u) < cfg.u_clip)
                 & (targets > task.dof_lower) & (targets < task.dof_upper)
                 & (torch.abs(tau_pd) < effort)).to(F32)
            m = torch.cat([torch.zeros_like(m[..., 0:2]), m[..., 2:]], dim=-1)
            dtau = torch.cat([torch.zeros((N, 6, nu), dtype=F32, device=dev),
                              torch.diag_embed(kp * m)], dim=-2)  # (N, nv, nu)
            L, inv_diag = cholesky_factor_unrolled(Hp)
            cols = dtau[:, p, :].transpose(-1, -2)        # (N, nu, nv)
            dudot = cholesky_substitute(L[:, None], inv_diag[:, None],
                                        cols)[..., ip]    # (N, nu, nv)
            _, B_k = vmap(lambda d: jvp(
                lambda ud: flatten_physics(engine._integrate(
                    model, scene, dyn, ph, ud, aux, h)), (udot,), (d,)),
                in_dims=1, out_dims=(None, 2))(dudot)     # (N, NX, nu)
            J = A_k @ J + torch.cat([torch.zeros_like(A_k), B_k], dim=-1)
            x_k = y
        return J

    # -- rollouts -------------------------------------------------------------
    @staticmethod
    def _nan_unless_finite(cost: Tensor, U: Tensor) -> Tensor:
        """The cost of a sequence with a non-finite action is NaN, as the
        plain engine makes it (NaN targets give NaN states); the CUDA
        kernel's clamps map a NaN target to a joint limit instead, which
        would let NaN actions (from overflowed Riccati gains) score and be
        accepted."""
        ok = torch.isfinite(U).all(dim=-1).all(dim=-1)
        return torch.where(ok, cost, torch.full_like(cost, float("nan")))

    def _rollout(self, env: EnvState, U: Tensor):
        """States BEFORE each action (S, H, NX) and each sequence's total
        raw cost (S,), U (S, H, nu)."""
        x = flatten_physics(env.physics)
        xs, cost = [], 0.0
        for t in range(U.shape[1]):
            x2 = self._f(env, x, U[:, t])
            xs.append(x)
            cost = cost + self._cost(env, x2, U[:, t])
            x = x2
        return torch.stack(xs, dim=1), self._nan_unless_finite(cost, U)

    def _rollout_cost(self, env: EnvState, U: Tensor) -> Tensor:
        """Total cost (S,) of the (S, H, nu) sequences from env."""
        return self._rollout(env, U)[1]

    def _lin_dyn(self, env: EnvState, xs: Tensor, U: Tensor):
        """Dynamics Jacobians along the nominal, all S*H rows at once."""
        S, H = U.shape[:2]
        A, Bm = self.linearize_dynamics(
            _repeat_rows(env, H, interleave=True), xs.reshape(S * H, NX),
            U.reshape(S * H, self.nu))
        return A.reshape(S, H, NX, NX), Bm.reshape(S, H, NX, self.nu)

    def _cost_grads(self, env: EnvState, xs: Tensor, U: Tensor, U_ws: Tensor):
        """Gradients of the stage cost at (x_t, u_t), the tether's added to
        cu (its Hessian joins the backward pass's regularizer)."""
        S, H = U.shape[:2]
        with torch.enable_grad():
            x = xs.reshape(S * H, NX).detach().requires_grad_(True)
            u = U.reshape(S * H, self.nu).detach().requires_grad_(True)
            cost = self._cost(_repeat_rows(env, H, interleave=True), x, u)
            # The kick cost does not read u: its gradient is then zero.
            gx, gu = torch.autograd.grad(cost.sum(), (x, u),
                                         allow_unused=True,
                                         materialize_grads=True)
        cu = gu.reshape(S, H, self.nu) + self.cfg.warm_reg * (U - U_ws)
        return gx.reshape(S, H, NX), cu

    def _tether(self, Us: Tensor, U_ws: Tensor):
        if self.cfg.warm_reg == 0.0:
            return 0.0
        return 0.5 * self.cfg.warm_reg * torch.sum((Us - U_ws) ** 2,
                                                   dim=(-2, -1))

    def _bf_pass(self, env: EnvState, env_ls: EnvState, U, xs, base_cost,
                 U_ws, A, Bm, cx, cu):
        """Riccati backward pass and the line-searched forward pass: the 4
        step sizes roll out as one batch of 4*S rows (row a*S + s)."""
        cfg = self.cfg
        backward = (parallel_backward if cfg.parallel_riccati
                    else sequential_backward)
        ks, Ks = backward(A, Bm, cx, cu, cfg.reg + cfg.warm_reg)
        S, H = U.shape[:2]
        n_a = len(cfg.line_search)
        alphas = torch.as_tensor(cfg.line_search, dtype=F32,
                                 device=U.device).repeat_interleave(S)

        def tile(v):
            return v.repeat((n_a,) + (1,) * (v.dim() - 1))

        U4, xs4, ks4, Ks4 = tile(U), tile(xs), tile(ks), tile(Ks)
        x = flatten_physics(env_ls.physics)
        us, xcs, raw = [], [], 0.0
        for t in range(H):
            u = U4[:, t] + alphas[:, None] * ks4[:, t] + (
                Ks4[:, t] @ (x - xs4[:, t])[..., None])[..., 0]
            u = u.clamp(-cfg.u_clip, cfg.u_clip)
            x2 = self._f(env_ls, x, u)
            us.append(u)
            xcs.append(x)
            raw = raw + self._cost(env_ls, x2, u)
            x = x2
        cand_U = torch.stack(us, dim=1).reshape(n_a, S, H, self.nu)
        cand_xs = torch.stack(xcs, dim=1).reshape(n_a, S, H, NX)
        cand_raw = self._nan_unless_finite(raw, torch.stack(us, dim=1)) \
            .reshape(n_a, S)
        cand_c = cand_raw + self._tether(cand_U, U_ws) if cfg.warm_reg \
            else cand_raw
        base_c = base_cost + self._tether(U, U_ws)
        best = torch.argmin(cand_c, dim=0)                    # (S,)
        rows = torch.arange(S, device=U.device)
        best_c = cand_c[best, rows]
        improved = best_c < base_c
        U_new = torch.where(improved[:, None, None], cand_U[best, rows], U)
        xs_new = torch.where(improved[:, None, None], cand_xs[best, rows], xs)
        cost_new = torch.where(improved, cand_raw[best, rows], base_cost)
        accepted = torch.where(improved, best, torch.full_like(best, -1))
        return (U_new, xs_new, cost_new,
                torch.where(improved, best_c, base_c), accepted)

    def solve(self, env_states: EnvState, sqp_states: SQPState, gen=None):
        """Batched solve over the S problems of env_states.

        Returns (actions (S, nu), SQPState(shifted nominal), info) with
        info["cost"] the final (tethered) cost per solve and
        info["accepted"] the index into cfg.line_search of the last
        iteration's accepted step (-1: none improved)."""
        cfg = self.cfg
        U = sqp_states.nominal
        U_ws = U      # trust-region anchor: the warm-start sequence
        n_a = len(cfg.line_search)
        env_ls = _repeat_rows(env_states, n_a, interleave=False)
        # The accepted candidate's states seed the next iteration, so only
        # the first pays a rollout of its own.
        xs, cost = self._rollout(env_states, U)
        tc = cost
        A = Bm = None
        accepted = None
        for k in range(cfg.iterations):
            if k % cfg.relinearize_every == 0:
                A, Bm = self._lin_dyn(env_states, xs, U)
            cx, cu = self._cost_grads(env_states, xs, U, U_ws)
            U, xs, cost, tc, accepted = self._bf_pass(
                env_states, env_ls, U, xs, cost, U_ws, A, Bm, cx, cu)
        actions = U[:, 0]
        shifted = torch.cat([U[:, 1:], U[:, -1:]], dim=1)
        info = {"cost": tc}
        if accepted is not None:
            info["accepted"] = accepted
        return actions, SQPState(nominal=shifted), info
