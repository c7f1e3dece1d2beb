"""The port's unrolled Cholesky and shared-factor solve against the JAX
package's (ops/linalg.py).

Inputs: random SPD matrices drawn with numpy, and a real Bez `H_eff` (the
joints-first reordered mass matrix of a kick reset state, from the JAX
engine's `_prepare`).  The JAX functions are single-matrix, so they run
under `jax.vmap`; the port's take the batch as leading dims.  The
shared-factor solve's JVP is held under `vmap` over 58 tangents (the SQP
state's width) against JAX's and against forward mode through the plain
unrolled solve; its backward by `gradcheck` in f64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bez_isaacgym_tpu.ops import linalg as jla  # noqa: E402
from bez_isaacgym_tpu_torch.ops import linalg as tla  # noqa: E402

N_TAN = 58


def _spd(rng, B, n):
    A = rng.normal(size=(B, n, n))
    return (A @ A.transpose(0, 2, 1) / n + 0.5 * np.eye(n)).astype(np.float32)


@pytest.fixture(scope="module")
def bez_h():
    """Joints-first reordered, symmetrized H_eff and tau of a kick reset
    state (in contact: the feet touch the ground)."""
    from bez_isaacgym_tpu.ops import engine as jengine
    from bez_isaacgym_tpu.ops import kinematics as jkin
    from bez_isaacgym_tpu.tasks.base import TaskConfig as JTaskConfig
    from bez_isaacgym_tpu.tasks.kick import KickTask as JKickTask

    task = JKickTask(JTaskConfig(substeps=1, use_pallas=False))
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    env = jax.jit(jax.vmap(task.reset_one))(keys)
    mask = jkin.ancestor_mask(task.model)

    def prep(dyn, ph):
        return jengine._prepare(task.model, task.scene, mask, dyn, ph,
                                task.default_dof_pos, task.scene.dt)[:2]

    H, tau = jax.jit(jax.vmap(prep))(env.dyn, env.physics)
    nv = H.shape[-1]
    perm = np.concatenate([np.arange(6, nv), np.arange(6)])
    Hs = 0.5 * (H + jnp.swapaxes(H, -1, -2))
    return np.asarray(Hs[:, perm][:, :, perm]), np.asarray(tau[:, perm]), \
        np.asarray(H), np.asarray(tau), perm


@pytest.fixture(scope="module")
def jfns():
    """The JAX functions, jitted once per module (vmapped over a batch)."""
    return {
        "factor": jax.jit(jax.vmap(jla.cholesky_factor_unrolled)),
        "substitute": jax.jit(jax.vmap(jla.cholesky_substitute)),
        "solve": jax.jit(jax.vmap(jla.cholesky_solve_unrolled)),
        "shared": jax.jit(jax.vmap(jla.solve_spd_shared_factor)),
    }


@pytest.mark.parametrize("n", [6, 12])
def test_factor_and_substitute_match_jax_on_random_spd(jfns, n):
    rng = np.random.default_rng(n)
    H = _spd(rng, 5, n)
    b = rng.normal(size=(5, n)).astype(np.float32)
    jL, jinv = jfns["factor"](jnp.asarray(H))
    L, inv = tla.cholesky_factor_unrolled(torch.as_tensor(H))
    # Entries of L are O(1) (eigenvalues of H in [0.5, ~5]); f32 rounding
    # of a different summation order: 1e-5.
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), atol=1e-5)
    np.testing.assert_allclose(inv.numpy(), np.asarray(jinv), rtol=1e-5)
    assert np.all(np.triu(L.numpy(), 1) == 0.0)
    x = tla.cholesky_substitute(L, inv, torch.as_tensor(b))
    jx = jfns["substitute"](jL, jinv, jnp.asarray(b))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-4,
                               atol=1e-5)
    for name, fn in (("solve", tla.cholesky_solve_unrolled),
                     ("shared", tla.solve_spd_shared_factor)):
        got = fn(torch.as_tensor(H), torch.as_tensor(b)).numpy()
        ref = np.asarray(jfns[name](jnp.asarray(H), jnp.asarray(b)))
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(
            got, np.linalg.solve(H.astype(np.float64), b[..., None])[..., 0],
            rtol=1e-4,
            atol=1e-5, err_msg=name)


def test_solves_match_jax_on_bez_h_eff(bez_h, jfns):
    Hp, taup, H, tau, perm = bez_h
    Ht, bt = torch.as_tensor(Hp), torch.as_tensor(taup)
    ref = np.linalg.solve(Hp.astype(np.float64),
                          taup.astype(np.float64)[..., None])[..., 0]
    scale = np.abs(ref).max()
    # (JAX's shared-factor forward is its cholesky_solve_unrolled.)
    jgot = np.asarray(jfns["shared"](jnp.asarray(Hp), jnp.asarray(taup)))
    for name, fn in (("solve", tla.cholesky_solve_unrolled),
                     ("shared", tla.solve_spd_shared_factor)):
        got = fn(Ht, bt).numpy()
        # The mass matrix spans ~6 decades (joint armature vs the base):
        # the two f32 solves agree, and sit within 1e-4 of the f64 solve,
        # relative to the largest acceleration.
        np.testing.assert_allclose(got, jgot, atol=1e-5 * scale,
                                   err_msg=name)
        np.testing.assert_allclose(got, ref, atol=1e-4 * scale,
                                   err_msg=name)
    # The ordered single-matrix wrapper symmetrizes and permutes itself.
    jord = jax.jit(jax.vmap(lambda h, t: jla.solve_spd_ordered_single(
        h, t, perm)))(jnp.asarray(H), jnp.asarray(tau))
    tord = tla.solve_spd_ordered_single(torch.as_tensor(H),
                                        torch.as_tensor(tau), perm)
    np.testing.assert_allclose(tord.numpy(), np.asarray(jord),
                               atol=1e-5 * scale)
    # And it is the engine's ordered solve (the right-looking batched one).
    tbat = tla.solve_spd_ordered(torch.as_tensor(H), torch.as_tensor(tau),
                                 perm)
    np.testing.assert_allclose(tord.numpy(), tbat.numpy(), atol=1e-5 * scale)


def _sym_tangents(rng, B, n):
    """N_TAN symmetric dH tangents and db tangents per matrix: the SQP
    differentiates a symmetrized H, so its dH is symmetric (the factor
    reads only H's lower triangle)."""
    dH = rng.normal(size=(N_TAN, B, n, n))
    dH = (0.5 * (dH + dH.transpose(0, 1, 3, 2))).astype(np.float32)
    db = rng.normal(size=(N_TAN, B, n)).astype(np.float32)
    return dH, db


@pytest.mark.parametrize("case", ["random", "bez"])
def test_shared_factor_jvp_under_vmap_matches_jax(case, bez_h):
    rng = np.random.default_rng(7)
    if case == "random":
        H = _spd(rng, 3, 12)
        b = rng.normal(size=(3, 12)).astype(np.float32)
    else:
        H, b = bez_h[0], bez_h[1]
    dH, db = _sym_tangents(rng, H.shape[0], H.shape[-1])
    Ht, bt = torch.as_tensor(H), torch.as_tensor(b)
    x, dx = torch.func.vmap(
        lambda a, c: torch.func.jvp(tla.solve_spd_shared_factor, (Ht, bt),
                                    (a, c)),
        out_dims=(None, 0))(torch.as_tensor(dH), torch.as_tensor(db))
    jfn = jax.jit(jax.vmap(
        lambda a, c: jax.jvp(jax.vmap(jla.solve_spd_shared_factor),
                             (jnp.asarray(H), jnp.asarray(b)), (a, c))[1]))
    jdx = np.asarray(jfn(jnp.asarray(dH), jnp.asarray(db)))
    # Forward mode through the plain unrolled solve (factor differentiated
    # per tangent): the same derivative.
    pdx = torch.func.vmap(lambda a, c: torch.func.jvp(
        tla.cholesky_solve_unrolled, (Ht, bt), (a, c))[1])(
        torch.as_tensor(dH), torch.as_tensor(db))
    assert dx.shape == (N_TAN,) + b.shape
    scale = np.abs(jdx).max()
    # Two triangular substitutions per tangent against the same factor in
    # both packages: f32 rounding, 1e-5 of the largest tangent (1e-4 on
    # the badly scaled Bez matrix, where the f32 factors differ more).
    tol = 1e-5 if case == "random" else 1e-4
    np.testing.assert_allclose(dx.numpy(), jdx, atol=tol * scale)
    np.testing.assert_allclose(dx.numpy(), pdx.numpy(), atol=tol * scale)


def test_shared_factor_jvp_reuses_the_primal_factor(monkeypatch):
    """Under vmap over 58 tangents the factor runs once, on the unbatched
    primal: the tangents only substitute."""
    rng = np.random.default_rng(3)
    H = torch.as_tensor(_spd(rng, 2, 8))
    b = torch.as_tensor(rng.normal(size=(2, 8)).astype(np.float32))
    dH, db = _sym_tangents(rng, 2, 8)
    calls = []
    real = tla.cholesky_factor_unrolled

    def counted(M, *a):
        calls.append(tuple(M.shape))
        return real(M, *a)

    monkeypatch.setattr(tla, "cholesky_factor_unrolled", counted)
    torch.func.vmap(lambda a, c: torch.func.jvp(
        tla.solve_spd_shared_factor, (H, b), (a, c))[1])(
        torch.as_tensor(dH), torch.as_tensor(db))
    assert calls == [(2, 8, 8)]


def test_shared_factor_backward_gradcheck_f64():
    """Reverse mode: b_bar = H^-1 x_bar, H_bar = -b_bar x^T, through a
    symmetrized H (the only H the physics solves), batched and single."""
    rng = np.random.default_rng(5)
    H = torch.tensor(_spd(rng, 2, 6), dtype=torch.float64,
                     requires_grad=True)
    b = torch.tensor(rng.normal(size=(2, 6)), dtype=torch.float64,
                     requires_grad=True)

    def sym_solve(M, v):
        return tla.solve_spd_shared_factor(0.5 * (M + M.transpose(-1, -2)),
                                           v)

    assert torch.autograd.gradcheck(sym_solve, (H, b))
    assert torch.autograd.gradcheck(
        sym_solve, (H[0].detach().requires_grad_(),
                    b[0].detach().requires_grad_()))
