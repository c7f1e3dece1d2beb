"""Whole SQP solves of the port against the JAX package's (S=2, H=3), from
the in-contact reset states of tests/test_torch_sqp.py.  Each JAX solve
takes minutes to trace on the CPU, so they get a file, and a test worker,
of their own.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bez_isaacgym_tpu.solvers import sqp as jsqp  # noqa: E402
from bez_isaacgym_tpu_torch.solvers.sqp import (SQPConfig,  # noqa: E402
                                                SQPSolver, SQPState)

from test_torch_sqp import H, NA, S, _port_task, case  # noqa: E402,F401


# Whole solves: the default, and every option of SQPConfig on at once
# (the tether, the balance term, the frozen-Jacobian second iteration, the
# parallel Riccati pass); each JAX solve takes ~50 s to trace on the CPU.
SOLVES = {
    "plain": dict(iterations=1),
    "all_options": dict(iterations=2, warm_reg=0.5, balance_weight=0.6,
                        relinearize_every=2, parallel_riccati=True),
}


@pytest.fixture(scope="module", params=list(SOLVES))
def solved(request, case):
    kw = SOLVES[request.param]
    U = np.random.default_rng(3).uniform(-0.2, 0.2, (S, H, NA)).astype(
        np.float32)
    js = jsqp.SQPSolver(case["jtask"], jsqp.SQPConfig(horizon=H, **kw))
    ja, jst, jinfo = jax.jit(js.solve)(
        case["jenv"], jsqp.SQPState(nominal=jnp.asarray(U)))
    ts = SQPSolver(_port_task(), SQPConfig(horizon=H, **kw))
    ta, tst, tinfo = ts.solve(case["tenv"],
                              SQPState(nominal=torch.as_tensor(U)))
    return (request.param, (np.asarray(ja), np.asarray(jst.nominal),
                            np.asarray(jinfo["cost"])),
            (ta.numpy(), tst.nominal.numpy(), tinfo))


def test_solve_matches_jax(solved):
    name, (ja, jnom, jcost), (ta, tnom, tinfo) = solved
    assert ta.shape == (S, NA) and tnom.shape == (S, H, NA)
    # The costs decide the line search: 1e-4 relative, so the accepted
    # step is the same, and then the actions and the shifted nominal are
    # the same sequences up to f32 rounding of H steps: 1e-4.
    np.testing.assert_allclose(tinfo["cost"].numpy(), jcost, rtol=1e-4,
                               atol=1e-6, err_msg=name)
    np.testing.assert_allclose(ta, ja, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(tnom, jnom, atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(tnom[:, -1], tnom[:, -2])
    acc = tinfo["accepted"].numpy()
    assert acc.shape == (S,) and np.all((acc >= -1) & (acc < 4))

