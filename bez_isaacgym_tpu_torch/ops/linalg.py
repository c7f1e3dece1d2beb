"""Small-matrix SPD solves for the physics step.

Port of `bez_isaacgym_tpu/ops/linalg.py:18-95`: a right-looking column
Cholesky with `sqrt(max(d, eps))` pivots and column-oriented substitutions,
written over the (static, small) matrix size on batched tensors, plus the
symmetrize-and-reorder wrapper the physics step solves with.
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
