"""The port's plain engine and the substep wrapper's CPU path against the
JAX engine and the Pallas kernel (interpret mode).

- Full Bez `stl` + ball at B=4, 2 control steps of substeps=2, per-env
  params (mass scale, friction, joint limits): `make_batched_step_fn` and
  `make_kernel_step_fn` (on CPU tensors: `substep_plain` through the
  kernel's packed buffers) against the JAX `make_batched_step_fn`.
- The chain model of tests/test_pallas_interpret.py at B=8, substeps=2
  against `make_pallas_step_fn(..., interpret=True)`, with that file's bars.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bez_isaacgym_tpu.models import bez as jbez  # noqa: E402
from bez_isaacgym_tpu.ops import engine as jeng  # noqa: E402
from bez_isaacgym_tpu.ops.pallas_step import make_pallas_step_fn  # noqa: E402
from bez_isaacgym_tpu_torch import convert  # noqa: E402
from bez_isaacgym_tpu_torch.models import bez  # noqa: E402
from bez_isaacgym_tpu_torch.ops import engine  # noqa: E402
from bez_isaacgym_tpu_torch.ops.substep import make_kernel_step_fn  # noqa: E402
from test_pallas_interpret import make_chain_model  # noqa: E402

B, STEPS = 4, 2
FIELDS = ["q", "qd", "base_pos", "base_quat", "base_u", "ball_pos",
          "ball_quat", "ball_vel", "ball_ang", "sensor_normal",
          "body_contact_force"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bez_case():
    m = jbez.load_bez_model("stl")
    cfg = jeng.SceneConfig(substeps=2)
    rng = np.random.default_rng(0)
    f = np.float32
    q0 = jbez.pose_vector(m, jbez.READY_JOINT_ANGLES).astype(f)
    s0 = jeng.default_state(m, cfg, q0, (0, 0, 0.33), (0, 0, 0, 1),
                            ball_pos=(0.12, 0.05, 0.08))
    st = jax.tree.map(lambda x: np.broadcast_to(x, (B,) + x.shape).copy(),
                      _np(s0))
    st = st._replace(
        q=(q0 + rng.uniform(-0.1, 0.1, (B, 18))).astype(f),
        qd=rng.uniform(-0.5, 0.5, (B, 18)).astype(f),
        base_u=rng.uniform(-0.2, 0.2, (B, 6)).astype(f),
        ball_vel=rng.uniform(-0.5, 0.5, (B, 3)).astype(f))
    p = jbez.default_dyn_params(m)
    lo = np.asarray(p.dof_lower) + rng.uniform(0, 0.05, (B, 18))
    hi = np.asarray(p.dof_upper) - rng.uniform(0, 0.05, (B, 18))
    params = jax.tree.map(
        lambda x: np.broadcast_to(np.asarray(x, f),
                                  (B,) + np.shape(x)).copy(), p)
    params = params._replace(
        mass_scale=rng.uniform(0.9, 1.1, (B, m.nb)).astype(f),
        ground_friction=rng.uniform(0.8, 1.2, B).astype(f),
        dof_lower=lo.astype(f), dof_upper=hi.astype(f))
    targets = (q0 + rng.uniform(-0.3, 0.3, (B, 18))).astype(f)
    return m, cfg, params, st, targets


@pytest.fixture(scope="module")
def bez_run():
    m, cfg, params, st, targets = _bez_case()
    step = jax.jit(jeng.make_batched_step_fn(m, cfg))
    ref = st
    for _ in range(STEPS):
        ref = step(params, ref, jnp.asarray(targets))
    tm = bez.load_bez_model("stl")
    tcfg = engine.SceneConfig(substeps=2)
    tp, ts = convert.dyn_params(params), convert.physics_state(st)
    tt = torch.as_tensor(targets)
    outs = {}
    for name, fn in (("engine", engine.make_batched_step_fn(tm, tcfg)),
                     ("kernel_wrapper", make_kernel_step_fn(tm, tcfg))):
        s = ts
        for _ in range(STEPS):
            s = fn(tp, s, tt)
        outs[name] = s
    return _np(ref), outs


@pytest.mark.parametrize("path", ["engine", "kernel_wrapper"])
@pytest.mark.parametrize("field", FIELDS)
def test_bez_step_matches_jax_engine(bez_run, path, field):
    ref, outs = bez_run
    got = getattr(outs[path], field).numpy()
    want = getattr(ref, field)
    assert got.shape == want.shape
    # Same f32 formulation and joints-first Cholesky; differences are
    # summation order only (measured <= 2e-6 on state).  Contact forces come
    # from kn=6000 N/m springs, so they carry a relative bar.
    if field in ("sensor_normal", "body_contact_force"):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-2)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_chain_matches_pallas_interpret():
    """The chain model through the port's kernel wrapper (CPU path) against
    the Pallas kernel in interpret mode; bars of
    tests/test_pallas_interpret.py::_parity_case."""
    jm = make_chain_model(2)
    cfg = jeng.SceneConfig(substeps=2, has_ball=False)
    n, atol = 8, 2e-3
    params = jax.tree.map(
        lambda x: np.broadcast_to(np.asarray(x, np.float32),
                                  (n,) + np.shape(x)).copy(),
        jbez.default_dyn_params(jm))
    q0 = np.zeros(2, np.float32)
    s0 = _np(jeng.default_state(jm, cfg, q0, (0, 0, 0.252), (0, 0, 0, 1)))
    st = jax.tree.map(lambda x: np.broadcast_to(x, (n,) + x.shape).copy(), s0)
    rng = np.random.default_rng(0)
    st = st._replace(q=rng.uniform(-0.1, 0.1, (n, 2)).astype(np.float32),
                     qd=rng.uniform(-0.2, 0.2, (n, 2)).astype(np.float32))
    tg = np.zeros((n, 2), np.float32)
    pl_step = jax.jit(make_pallas_step_fn(jm, cfg, block_b=n, interpret=True))
    ref = st
    tm = convert.robot_model(jm)
    tstep = make_kernel_step_fn(tm, engine.SceneConfig(substeps=2,
                                                       has_ball=False))
    out = convert.physics_state(st)
    tp = convert.dyn_params(params)
    for _ in range(3):
        ref = pl_step(params, ref, jnp.asarray(tg))
        out = tstep(tp, out, torch.as_tensor(tg))
    ref = _np(ref)
    np.testing.assert_allclose(out.q.numpy(), ref.q, atol=atol)
    np.testing.assert_allclose(out.qd.numpy(), ref.qd, atol=50 * atol)
    np.testing.assert_allclose(out.base_pos.numpy(), ref.base_pos, atol=atol)
    np.testing.assert_allclose(out.base_quat.numpy(), ref.base_quat,
                               atol=2 * atol)
    assert not torch.isnan(out.qd).any()
    # Contact holds the chain up (no fall-through, no launch).
    assert float((out.base_pos[:, 2] - 0.252).abs().max()) < 0.02


def test_make_step_fn_single_env_matches_batched():
    """make_step_fn runs on one env's unbatched tensors."""
    m, _, params, st, targets = _bez_case()
    tm = bez.load_bez_model("stl")
    tcfg = engine.SceneConfig(substeps=2)
    tp, ts = convert.dyn_params(params), convert.physics_state(st)
    batched = engine.make_batched_step_fn(tm, tcfg)(tp, ts,
                                                    torch.as_tensor(targets))
    one = engine.make_step_fn(tm, tcfg)(
        type(tp)(*[x[1] if torch.is_tensor(x) else x for x in tp]),
        type(ts)(*[x[1] for x in ts]), torch.as_tensor(targets[1]))
    torch.testing.assert_close(one.q, batched.q[1], atol=1e-5, rtol=0)
    torch.testing.assert_close(one.base_pos, batched.base_pos[1], atol=1e-6,
                               rtol=0)


def test_default_state_matches_jax():
    jm = jbez.load_bez_model("stl")
    q0 = jbez.pose_vector(jm, jbez.READY_JOINT_ANGLES).astype(np.float32)
    ref = _np(jeng.default_state(jm, jeng.SceneConfig(), q0, (0, 0, 0.34),
                                 (0, 0, 0, 1)))
    got = engine.default_state(bez.load_bez_model("stl"),
                               engine.SceneConfig(), torch.as_tensor(q0),
                               (0, 0, 0.34), (0, 0, 0, 1))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(ref, f))
