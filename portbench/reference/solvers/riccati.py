"""Riccati backward passes: a sequential loop and a parallel-in-time scan.

Frozen copy of the port's `solvers/riccati.py` at commit 391cc8b (see
`portbench/reference/__init__.py`).  The LQ subproblem of each
SQP iteration (solvers/sqp.py), in deviation coordinates:

    dx_{t+1} = A_t dx_t + B_t du_t
    cost_t   = cx_t^T dx_t + cu_t^T du_t + 1/2 reg (|dx_t|^2 + |du_t|^2)

`sequential_backward` is the O(T) Riccati recursion, a Python loop over T
run backwards.  `parallel_backward` evaluates the same recursion in
O(log T) depth with the conditional-value-function elements of Särkkä and
García-Fernández, "Temporal Parallelization of Dynamic Programming and
Linear Quadratic Control" (IEEE TAC 2021), composed by an associative scan
written in plain torch (PyTorch has no public one).  Both take any leading
batch dims before (T, ...), e.g. S solves.  The TF32 flags are
`portbench.compare.precision`'s (off for the reference, on for its
control).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.ops.linalg import cholesky_solve_unrolled

Tensor = torch.Tensor


class LQGains(NamedTuple):
    k: Tensor    # (..., T, m) feedforward
    K: Tensor    # (..., T, m, n) feedback


def _t(x: Tensor) -> Tensor:
    return x.transpose(-1, -2)


def sequential_backward(A, B, cx, cu, reg: float) -> LQGains:
    """The Riccati recursion: A (..., T, n, n), B (..., T, n, m), cx
    (..., T, n), cu (..., T, m)."""
    T, n = A.shape[-3], A.shape[-1]
    m = B.shape[-1]
    batch = A.shape[:-3]
    I_n = torch.eye(n, dtype=A.dtype, device=A.device)
    I_m = torch.eye(m, dtype=A.dtype, device=A.device)
    Vx = torch.zeros(batch + (n,), dtype=A.dtype, device=A.device)
    Vxx = (reg * I_n).expand(batch + (n, n))
    ks, Ks = [None] * T, [None] * T
    for t in reversed(range(T)):
        A_t, B_t = A[..., t, :, :], B[..., t, :, :]
        Qx = cx[..., t, :] + (_t(A_t) @ Vx[..., None])[..., 0]
        Qu = cu[..., t, :] + (_t(B_t) @ Vx[..., None])[..., 0]
        VA = Vxx @ A_t
        Qxx = _t(A_t) @ VA + reg * I_n
        Quu = _t(B_t) @ Vxx @ B_t + reg * I_m
        Qux = _t(B_t) @ VA
        # SPD Quu: one unrolled Cholesky with [Qu | Qux] stacked as
        # right-hand sides (the columns become a batch dim).
        rhs = torch.cat([Qu[..., None], Qux], dim=-1)     # (..., m, 1+n)
        kK = -_t(cholesky_solve_unrolled(Quu[..., None, :, :], _t(rhs)))
        k, K = kK[..., 0], kK[..., 1:]
        Vx = Qx + (_t(K) @ Qu[..., None])[..., 0]
        Vxx = Qxx + _t(K) @ Qux
        Vxx = 0.5 * (Vxx + _t(Vxx))
        ks[t], Ks[t] = k, K
    return LQGains(k=torch.stack(ks, dim=-2), K=torch.stack(Ks, dim=-3))


class _Elem(NamedTuple):
    """Conditional value function between two times (Särkkä-GF §III)."""

    A: Tensor     # (..., n, n)
    b: Tensor     # (..., n)
    C: Tensor     # (..., n, n)
    eta: Tensor   # (..., n)
    J: Tensor     # (..., n, n)


def _mv(M: Tensor, v: Tensor) -> Tensor:
    return (M @ v[..., None])[..., 0]


def _combine(ei: _Elem, ej: _Elem) -> _Elem:
    """e_i covers [s, t), e_j covers [t, r) -> the combined [s, r)."""
    n = ei.A.shape[-1]
    I = torch.eye(n, dtype=ei.A.dtype, device=ei.A.device)
    # (I + C_i J_j) and (I + J_j C_i) solves shared by all five outputs.
    M1 = torch.linalg.solve(I + ei.C @ ej.J, torch.cat(
        [ei.A, (ei.b + _mv(ei.C, ej.eta))[..., None], ei.C], dim=-1))
    S_A, S_b, S_C = M1[..., :n], M1[..., n], M1[..., n + 1:]
    M2 = torch.linalg.solve(I + ej.J @ ei.C, torch.cat(
        [(ej.eta - _mv(ej.J, ei.b))[..., None], ej.J @ ei.A], dim=-1))
    T_eta, T_JA = M2[..., 0], M2[..., 1:]
    return _Elem(
        A=ej.A @ S_A,
        b=_mv(ej.A, S_b) + ej.b,
        C=ej.A @ S_C @ _t(ej.A) + ej.C,
        eta=_mv(_t(ei.A), T_eta) + ei.eta,
        J=_t(ei.A) @ T_JA + ei.J,
    )


def _cat(parts) -> _Elem:
    """Elements concatenated along the time axis."""
    return _Elem(*[torch.cat([getattr(p, f) for p in parts],
                             dim=-3 if f in ("A", "C", "J") else -2)
                   for f in _Elem._fields])


def _time_slice(e: _Elem, start: int, stop: int) -> _Elem:
    return _Elem(A=e.A[..., start:stop, :, :], b=e.b[..., start:stop, :],
                 C=e.C[..., start:stop, :, :], eta=e.eta[..., start:stop, :],
                 J=e.J[..., start:stop, :, :])


def _suffix_scan(e: _Elem) -> _Elem:
    """Inclusive suffix composition over the time axis: out[t] = e[t] o
    e[t+1] o ... o e[L-1], `_combine(earlier, later)` as
    `jax.lax.associative_scan(..., reverse=True)` orders the operands.
    ceil(log2 L) rounds; in the round of offset d every element t with
    t + d < L, which covers [t, t+d), takes in the one covering
    [t+d, t+2d), all in one batched `_combine`."""
    L = e.A.shape[-3]
    d = 1
    while d < L:
        head = _combine(_time_slice(e, 0, L - d), _time_slice(e, d, L))
        e = _cat([head, _time_slice(e, L - d, L)])
        d *= 2
    return e


def parallel_backward(A, B, cx, cu, reg: float) -> LQGains:
    """Associative-scan Riccati: the gains of `sequential_backward`.

    Element init (the control's linear term absorbed by the shift
    v = du + U^-1 cu, U = reg I):
      A_t = A_t, b_t = -B_t U^-1 cu_t, C_t = B_t U^-1 B_t^T,
      eta_t = -cx_t (V's linear term: Vx = J x - eta), J_t = reg I;
    terminal element (0, 0, 0, 0, reg I).
    """
    T, n = A.shape[-3], A.shape[-1]
    m = B.shape[-1]
    batch = A.shape[:-3]
    dt, dev = A.dtype, A.device
    inv_reg = 1.0 / reg
    eye_n = torch.eye(n, dtype=dt, device=dev)
    elems = _Elem(
        A=A,
        b=-inv_reg * torch.einsum("...tnm,...tm->...tn", B, cu),
        C=inv_reg * torch.einsum("...tnm,...tkm->...tnk", B, B),
        eta=-cx,
        J=(reg * eye_n).expand(batch + (T, n, n)),
    )
    zero_nn = torch.zeros(batch + (1, n, n), dtype=dt, device=dev)
    zero_n = torch.zeros(batch + (1, n), dtype=dt, device=dev)
    terminal = _Elem(A=zero_nn, b=zero_n, C=zero_nn, eta=zero_n,
                     J=(reg * eye_n).expand(batch + (1, n, n)))
    suffix = _suffix_scan(_cat([elems, terminal]))
    # V_{t+1}: quadratic J, linear -eta, for t = 0..T-1.
    J_next = suffix.J[..., 1:, :, :]
    eta_next = suffix.eta[..., 1:, :]
    Qu = cu + torch.einsum("...tnm,...tn->...tm", B, -eta_next)
    Quu = reg * torch.eye(m, dtype=dt, device=dev) \
        + torch.einsum("...tnm,...tnk,...tkl->...tml", B, J_next, B)
    Qux = torch.einsum("...tnm,...tnk,...tkl->...tml", B, J_next, A)
    rhs = torch.cat([Qu[..., None], Qux], dim=-1)     # (..., T, m, 1+n)
    kK = -_t(cholesky_solve_unrolled(Quu[..., None, :, :], _t(rhs)))
    return LQGains(k=kK[..., 0], K=kK[..., 1:])
