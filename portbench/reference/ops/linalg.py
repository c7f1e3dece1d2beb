"""Small-matrix SPD solves for the physics step and the SQP stage.

Port of `bez_isaacgym_tpu/ops/linalg.py`: a right-looking column
Cholesky with `sqrt(max(d, eps))` pivots and column-oriented substitutions,
written over the (static, small) matrix size on batched tensors, plus the
symmetrize-and-reorder wrapper the physics step solves with; and the
unrolled factor / substitution pair with the shared-factor solve whose
forward-mode derivative reuses the primal factor (the SQP linearization's
solve).  Every function takes any leading batch dims.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def batched_cholesky_solve(H: Tensor, b: Tensor, eps: float = 1e-9) -> Tensor:
    """Solve H x = b for a batch of SPD systems, (..., n, n) @ (..., n)."""
    n = b.shape[-1]
    X = H.clone()
    cols = []
    inv_diag = []
    for j in range(n):
        d = torch.sqrt(X[..., j, j].clamp_min(eps))
        inv_d = 1.0 / d
        col = X[..., :, j] * inv_d[..., None]
        col = torch.cat([torch.zeros_like(col[..., :j]), d[..., None],
                         col[..., j + 1:]], dim=-1)
        cols.append(col)
        inv_diag.append(inv_d)
        X = X - col[..., :, None] * col[..., None, :]

    # Forward: L y = b.
    ys = []
    r = b
    for j in range(n):
        yj = r[..., j] * inv_diag[j]
        ys.append(yj)
        r = r - cols[j] * yj[..., None]

    # Backward: L^T x = y; L[i, j] = cols[j][i].
    L = torch.stack(cols, dim=-1)                        # (..., n, n)
    xs = [None] * n
    r = torch.stack(ys, dim=-1)
    for i in reversed(range(n)):
        xi = r[..., i] * inv_diag[i]
        xs[i] = xi
        r = r - L[..., i, :] * xi[..., None]
    return torch.stack(xs, dim=-1)


def solve_spd_ordered(H: Tensor, b: Tensor, order: np.ndarray) -> Tensor:
    """Symmetrize + statically reorder + batched Cholesky solve.

    `order` is the elimination order (joints before base for an
    articulated-body mass matrix: eliminating the small joint diagonals
    first avoids the catastrophic cancellation that base-first elimination
    causes in f32).
    """
    perm = torch.as_tensor(np.asarray(order), device=H.device)
    iperm = torch.argsort(perm)
    Hs = 0.5 * (H + H.transpose(-1, -2))
    Hp = Hs[..., perm, :][..., :, perm]
    xp = batched_cholesky_solve(Hp, b[..., perm])
    return xp[..., iperm]


def solve_spd_ordered_single(H: Tensor, b: Tensor,
                             order: np.ndarray) -> Tensor:
    """Symmetrize + reorder + shared-factor solve (`solve_spd_ordered` with
    the unrolled row-oriented factor; forward mode through it factors
    once)."""
    perm = torch.as_tensor(np.asarray(order), device=H.device)
    iperm = torch.argsort(perm)
    Hs = 0.5 * (H + H.transpose(-1, -2))
    Hp = Hs[..., perm, :][..., :, perm]
    xp = solve_spd_shared_factor(Hp, b[..., perm])
    return xp[..., iperm]


def cholesky_factor_unrolled(H: Tensor, eps: float = 1e-9):
    """Unrolled Cholesky of SPD H (..., n, n) -> (L, inv_diag).

    L (..., n, n) is lower-triangular with the diagonal stored both in L
    and as reciprocals in inv_diag (..., n), so the substitutions multiply
    instead of divide.  Column by column (right-looking): l_jj =
    sqrt(max(x_jj, eps)), l_ij = x_ij / l_jj below it, then the trailing
    block takes off l_j l_j^T; the entries are those of the JAX package's
    row-oriented form, l_ij = (h_ij - sum_k<j l_ik l_jk) / l_jj, in n
    steps of a few batched launches instead of n^2/2.  Only H's lower
    triangle is read.
    """
    n = H.shape[-1]
    X = H
    cols, inv_diag = [], []
    for j in range(n):
        d = torch.sqrt(X[..., 0, 0].clamp_min(eps))
        inv_d = 1.0 / d
        col = X[..., 1:, 0] * inv_d[..., None]
        cols.append(torch.cat([torch.zeros_like(H[..., :j, 0]), d[..., None],
                               col], dim=-1))
        inv_diag.append(inv_d)
        X = X[..., 1:, 1:] - col[..., :, None] * col[..., None, :]
    return torch.stack(cols, dim=-1), torch.stack(inv_diag, dim=-1)


def cholesky_substitute(L: Tensor, inv_diag: Tensor, b: Tensor) -> Tensor:
    """Solve L L^T x = b (..., n) from a factor of cholesky_factor_unrolled:
    row-oriented forward then backward substitution, unrolled over n."""
    n = L.shape[-1]
    y = []
    for i in range(n):
        acc = b[..., i]
        if i:
            acc = acc - torch.sum(L[..., i, :i] * torch.stack(y, dim=-1),
                                  dim=-1)
        y.append(acc * inv_diag[..., i])
    x = [None] * n
    for i in reversed(range(n)):
        acc = y[i]
        if i + 1 < n:
            acc = acc - torch.sum(L[..., i + 1:, i]
                                  * torch.stack(x[i + 1:], dim=-1), dim=-1)
        x[i] = acc * inv_diag[..., i]
    return torch.stack(x, dim=-1)


def cholesky_solve_unrolled(H: Tensor, b: Tensor, eps: float = 1e-9) -> Tensor:
    """Solve H x = b for SPD H (..., n, n) by the unrolled factor and
    substitutions."""
    L, inv_diag = cholesky_factor_unrolled(H, eps)
    return cholesky_substitute(L, inv_diag, b)


class _SharedFactorSolve(torch.autograd.Function):
    """H x = b whose derivatives reuse the forward pass's factor.

    Forward mode: dx = H^-1 (db - dH x), two substitutions per tangent
    against the one factor; under `torch.func.vmap` over tangents the
    primal stays unbatched, so 58 state tangents share one factor.
    Reverse mode: b_bar = H^-1 x_bar, H_bar = -b_bar x^T, without
    differentiating through the unrolled factor.
    """

    generate_vmap_rule = True

    @staticmethod
    def forward(H, b):
        L, inv_diag = cholesky_factor_unrolled(H)
        return cholesky_substitute(L, inv_diag, b), L, inv_diag

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, L, inv_diag = output
        ctx.mark_non_differentiable(L, inv_diag)
        ctx.save_for_backward(L, inv_diag, x)
        ctx.save_for_forward(L, inv_diag, x)

    @staticmethod
    def jvp(ctx, dH, db):
        L, inv_diag, x = ctx.saved_tensors
        rhs = db if dH is None else \
            db - torch.einsum("...ij,...j->...i", dH, x)
        return cholesky_substitute(L, inv_diag, rhs), None, None

    @staticmethod
    def backward(ctx, x_bar, _L_bar, _inv_bar):
        L, inv_diag, x = ctx.saved_tensors
        b_bar = cholesky_substitute(L, inv_diag, x_bar)
        H_bar = -b_bar[..., :, None] * x[..., None, :]
        return H_bar, b_bar


def solve_spd_shared_factor(H: Tensor, b: Tensor) -> Tensor:
    """SPD solve H (..., n, n) x = b (..., n) by the unrolled Cholesky, with
    a forward-mode derivative that reuses the primal factor (port of
    `bez_isaacgym_tpu/ops/linalg.py:157-184`; see `_SharedFactorSolve`)."""
    return _SharedFactorSolve.apply(H, b)[0]
