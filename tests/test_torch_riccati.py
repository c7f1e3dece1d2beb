"""The port's Riccati backward passes against the JAX package's
(solvers/riccati.py): the sequential recursion and the associative-scan
one, each against its JAX counterpart and against each other, at the
shapes of tests/test_riccati.py: (T, n, m) = (8, 6, 3) and (32, 12, 5)
single, and S=4 solves of (16, 8, 4) batched (the JAX side under vmap,
the port's as a leading dim)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bez_isaacgym_tpu.solvers import riccati as jric  # noqa: E402
from bez_isaacgym_tpu_torch.solvers import riccati as tric  # noqa: E402

CASES = {"8x6x3": ((), 8, 6, 3, 1e-2), "32x12x5": ((), 32, 12, 5, 1e-2),
         "batched_4x16x8x4": ((4,), 16, 8, 4, 1e-3)}


def _random_lqt(rng, batch, T, n, m, scale=0.9):
    """Contractive A (scaled orthogonal), as tests/test_riccati.py draws."""
    q, r = np.linalg.qr(rng.normal(size=batch + (T, n, n)))
    A = scale * q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[..., None, :]
    B = rng.normal(size=batch + (T, n, m)) / np.sqrt(n)
    cx = rng.normal(size=batch + (T, n))
    cu = rng.normal(size=batch + (T, m))
    return [x.astype(np.float32) for x in (A, B, cx, cu)]


@pytest.fixture(scope="module", params=list(CASES))
def solved(request):
    batch, T, n, m, reg = CASES[request.param]
    args = _random_lqt(np.random.default_rng(T * n), batch, T, n, m)
    out = {}
    for name in ("sequential_backward", "parallel_backward"):
        jfn = getattr(jric, name)
        if batch:
            jfn = jax.vmap(lambda a, b, x, u, f=jfn: f(a, b, x, u, reg))
        else:
            jfn = (lambda a, b, x, u, f=jfn: f(a, b, x, u, reg))
        j = jax.jit(jfn)(*map(jnp.asarray, args))
        t = getattr(tric, name)(*map(torch.as_tensor, args), reg)
        out[name] = ((np.asarray(j.k), np.asarray(j.K)),
                     (t.k.numpy(), t.K.numpy()))
    return request.param, out


@pytest.mark.parametrize("name", ["sequential_backward", "parallel_backward"])
def test_pass_matches_jax(solved, name):
    case, out = solved
    (jk, jK), (tk, tK) = out[name]
    batch, T, n, m, _ = CASES[case]
    assert tk.shape == batch + (T, m) and tK.shape == batch + (T, m, n)
    # The same recursion in f32 (matmuls pinned to full f32 on both
    # sides); the sequential pass compounds T steps of rounding and the
    # scan log2(T+1) rounds of 12x12 solves: test_riccati.py's bars.
    np.testing.assert_allclose(tK, jK, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(tk, jk, rtol=2e-3, atol=2e-4)


def test_parallel_matches_sequential(solved):
    case, out = solved
    _, (sk, sK) = out["sequential_backward"]
    _, (pk, pK) = out["parallel_backward"]
    tol = (5e-3, 5e-4) if CASES[case][0] else (2e-3, 2e-4)
    np.testing.assert_allclose(pK, sK, rtol=tol[0], atol=tol[1])
    np.testing.assert_allclose(pk, sk, rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("L", [1, 2, 5, 9])
def test_suffix_scan_composes_every_suffix(L):
    """The scan's out[t] is the left-to-right composition of elements
    t..L-1, for lengths that are and are not powers of two."""
    rng = np.random.default_rng(L)
    n = 3
    A, B, cx, cu = _random_lqt(rng, (), L, n, 2)
    e = tric._Elem(A=torch.as_tensor(A),
                   b=torch.as_tensor(rng.normal(size=(L, n)),
                                     dtype=torch.float32),
                   C=torch.as_tensor(np.einsum("tnm,tkm->tnk", B, B)),
                   eta=torch.as_tensor(cx),
                   J=torch.eye(n).expand(L, n, n).clone())
    out = tric._suffix_scan(e)
    for t in range(L):
        ref = tric._time_slice(e, L - 1, L)
        for s in reversed(range(t, L - 1)):
            ref = tric._combine(tric._time_slice(e, s, s + 1), ref)
        for f in tric._Elem._fields:
            np.testing.assert_allclose(
                getattr(out, f)[t].numpy(), getattr(ref, f)[0].numpy(),
                rtol=1e-4, atol=1e-5, err_msg=f"{f} t={t}")
