"""The CUDA kernel's warp schedule, compiled for the host, against the plain
version.

`csrc/substep_body.cuh` is `__host__ __device__`.  A small C shim runs it as
the kernel does, block by block of BEZ_ENVS_PER_BLOCK envs: it stages the
block's input rows into the env tiles (`bez_stage_in`, every thread of the
block in turn), runs the lane
schedule of each env (`bez_substep_warp`) with one thread walking every lane
block's items in turn, forward or last to first, and writes the output rows
back (`bez_stage_out`).  The tiles start as NaN, so a read of scratch that
no earlier block wrote shows in the output.  Built with g++ and loaded with
ctypes, this holds the kernel's arithmetic (FK, contacts, mass matrix,
joints-first Cholesky, integration) against `substep_plain` on the CPU,
where no CUDA compiler exists.  The g++ build is test-only; the package
builds the .cu with nvcc.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from bez_isaacgym_tpu_torch import convert  # noqa: E402
from bez_isaacgym_tpu_torch.models import bez  # noqa: E402
from bez_isaacgym_tpu_torch.ops import _build, engine  # noqa: E402
from bez_isaacgym_tpu_torch.ops import substep as ss  # noqa: E402
from test_pallas_interpret import make_chain_model  # noqa: E402

SHIM = r"""
#include <math.h>
#include <vector>
#include "substep_body.cuh"
extern "C" int tables_size() { return (int)sizeof(SubstepTables); }
extern "C" int envs_per_block() { return BEZ_ENVS_PER_BLOCK; }
extern "C" void substep_host(const void* t, const float* s, const float* p,
                             float* o, int B, int reverse) {
  const SubstepTables& M = *(const SubstepTables*)t;
  const Layout L = bez_layout(M);
  const int E = BEZ_ENVS_PER_BLOCK;
  std::vector<float> tiles((size_t)E * L.size);
  for (int env0 = 0; env0 < B; env0 += E) {
    const int n_env = B - env0 < E ? B - env0 : E;
    for (float& v : tiles) v = NAN;
    for (int t = 0; t < E * BEZ_WARP; ++t)
      bez_stage_in(M, L, E, t, env0, n_env, B, s, p, tiles.data());
    Lanes lanes;
    lanes.lane = 0;
    lanes.reverse = reverse != 0;
    for (int w = 0; w < n_env; ++w)
      bez_substep_warp(lanes, M, L, tiles.data() + (size_t)w * L.size);
    for (int t = 0; t < E * BEZ_WARP; ++t)
      bez_stage_out(M, L, E, t, env0, n_env, B, tiles.data(), o);
  }
}
"""

VARIANTS = ["stl", "box", "box_sensor", "stl_sensor"]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available to build the kernel body for the host")
    d = tmp_path_factory.mktemp("substep_host")
    (d / "shim.cpp").write_text(SHIM)
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-I", str(_build.CSRC_DIR), "-o", str(d / "shim.so"),
                    str(d / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "shim.so"))
    lib.substep_host.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    lib.tables_size.restype = ctypes.c_int
    lib.envs_per_block.restype = ctypes.c_int
    return lib


def host_substep(lib, tables, state_in, params_in, reverse=False):
    out = torch.full((ss.out_rows(tables.model.nq, tables.model.nb),
                      state_in.shape[1]), float("nan"), dtype=torch.float32)
    lib.substep_host(ctypes.addressof(tables.struct), state_in.data_ptr(),
                     params_in.data_ptr(), out.data_ptr(), state_in.shape[1],
                     int(reverse))
    return out


def _inputs(model, cfg, B, seed, base_z=0.33):
    rng = np.random.default_rng(seed)
    q0 = bez.pose_vector(model, bez.READY_JOINT_ANGLES) \
        if model.nq == 18 else np.zeros(model.nq)
    q = torch.tensor(q0[None] + rng.uniform(-0.1, 0.1, (B, model.nq)),
                     dtype=torch.float32)
    st = engine.default_state(model, cfg, q, (0, 0, base_z), (0, 0, 0, 1),
                              ball_pos=(0.1, 0.05, 0.085))
    st = st._replace(
        qd=torch.tensor(rng.uniform(-0.5, 0.5, (B, model.nq)),
                        dtype=torch.float32),
        base_u=torch.tensor(rng.uniform(-0.3, 0.3, (B, 6)),
                            dtype=torch.float32),
        ball_vel=torch.tensor(rng.uniform(-1, 1, (B, 3)),
                              dtype=torch.float32))
    params = bez.default_dyn_params(model)
    targets = torch.tensor(q0[None] + rng.uniform(-0.3, 0.3, (B, model.nq)),
                           dtype=torch.float32)
    return st, params, targets


def test_tables_layout_matches_c(host_lib):
    assert host_lib.tables_size() == ctypes.sizeof(ss._Tables)


@pytest.mark.parametrize("B", [16, 7])
@pytest.mark.parametrize("variant", VARIANTS)
def test_body_matches_plain_one_substep(host_lib, variant, B):
    model = bez.load_bez_model(variant)
    cfg = engine.SceneConfig(substeps=2)
    tables = ss.KernelTables(model, cfg)
    st, params, targets = _inputs(model, cfg, B, seed=B)
    x = ss.pack_state(st)
    p = ss.pack_params(model, params, targets)
    got = host_substep(host_lib, tables, x, p)
    ref = ss.substep_plain(tables, x, p)
    n = ss.state_rows(model.nq)
    # Same inputs, one substep, the same f32 formulas; differences are
    # summation order and the un-symmetrized H (measured <= 1e-4 on the
    # base angular velocity rows).
    np.testing.assert_allclose(got[:n].numpy(), ref[:n].numpy(), atol=5e-4)
    # Sensor sums and body contact forces: kn=6000 N/m springs.
    np.testing.assert_allclose(got[n:].numpy(), ref[n:].numpy(), rtol=1e-3,
                               atol=1e-2)


def test_schedule_lane_order_is_bit_identical(host_lib):
    """Each lane block's items run first to last and last to first give the
    same bits: no item reads what another item of its block writes.  Bez
    `stl` with the ball against the left leg, so the box and ball stages,
    the damped inertias and every velocity term are live."""
    model = bez.load_bez_model("stl")
    cfg = engine.SceneConfig(substeps=2)
    tables = ss.KernelTables(model, cfg)
    st, params, targets = _inputs(model, cfg, 16, seed=3, base_z=0.32)
    x = ss.pack_state(st)
    p = ss.pack_params(model, params, targets)
    act = ss.contact_activity(tables, x)
    assert act.box.sum() > 0 and act.plane.sum() > 0
    fwd = host_substep(host_lib, tables, x, p)
    rev = host_substep(host_lib, tables, x, p, reverse=True)
    assert torch.isfinite(fwd).all()
    assert torch.equal(fwd, rev)


def test_ragged_tail_of_the_last_block(host_lib):
    """B = 2 E + 3: two full blocks and one of three envs; every env
    matches the plain version at the bars of the one-substep test."""
    E = host_lib.envs_per_block()
    B = 2 * E + 3
    model = bez.load_bez_model("box_sensor")
    cfg = engine.SceneConfig(substeps=2)
    tables = ss.KernelTables(model, cfg)
    st, params, targets = _inputs(model, cfg, B, seed=11)
    x = ss.pack_state(st)
    p = ss.pack_params(model, params, targets)
    got = host_substep(host_lib, tables, x, p)
    ref = ss.substep_plain(tables, x, p)
    n = ss.state_rows(model.nq)
    np.testing.assert_allclose(got[:n].numpy(), ref[:n].numpy(), atol=5e-4)
    np.testing.assert_allclose(got[n:].numpy(), ref[n:].numpy(), rtol=1e-3,
                               atol=1e-2)


def test_body_matches_plain_chain(host_lib):
    model = convert.robot_model(make_chain_model(2))
    cfg = engine.SceneConfig(substeps=2, has_ball=False)
    tables = ss.KernelTables(model, cfg)
    st, params, targets = _inputs(model, cfg, 8, seed=0, base_z=0.252)
    x = ss.pack_state(st)
    p = ss.pack_params(model, params, targets)
    got = host_substep(host_lib, tables, x, p)
    ref = ss.substep_plain(tables, x, p)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_body_five_steps_within_kernel_bars(host_lib):
    """Five control steps (substeps=2) chained through the body, against the
    plain step, at the bars the JAX package holds its TPU kernel to
    (tests/test_pallas.py): q and base_pos 2e-3, base_quat 5e-3, ball 1e-3."""
    model = bez.load_bez_model("stl")
    cfg = engine.SceneConfig(substeps=2)
    tables = ss.KernelTables(model, cfg)
    st, params, targets = _inputs(model, cfg, 32, seed=5, base_z=0.34)
    p = ss.pack_params(model, params, targets)
    x = ss.pack_state(st)
    n = ss.state_rows(model.nq)
    plain = engine.make_batched_step_fn(model, cfg)
    ref = st
    for _ in range(5):
        for _ in range(cfg.substeps):
            out = host_substep(host_lib, tables, x, p)
            x = out[:n].contiguous()
        ref = plain(params, ref, targets)
    got = ss.unpack_out(model, out)
    np.testing.assert_allclose(got.q.numpy(), ref.q.numpy(), atol=2e-3)
    np.testing.assert_allclose(got.base_pos.numpy(), ref.base_pos.numpy(),
                               atol=2e-3)
    np.testing.assert_allclose(got.base_quat.numpy(), ref.base_quat.numpy(),
                               atol=5e-3)
    np.testing.assert_allclose(got.ball_pos.numpy(), ref.ball_pos.numpy(),
                               atol=1e-3)


def test_body_honours_per_env_joint_limits(host_lib):
    """Per-env dof limits are inputs: env 0's tightened upper limit pins its
    joint 2, env 1 moves past it (tests/test_pallas.py:148-167)."""
    model = bez.load_bez_model("stl")
    cfg = engine.SceneConfig(substeps=2)
    tables = ss.KernelTables(model, cfg)
    B = 4
    st, params, _ = _inputs(model, cfg, B, seed=2, base_z=0.34)
    hi = np.broadcast_to(model.dof_upper, (B, 18)).astype(np.float32).copy()
    hi[0, 2] = float(st.q[0, 2])
    params = params._replace(dof_upper=hi)
    targets = torch.tensor(np.broadcast_to(model.dof_upper, (B, 18)),
                           dtype=torch.float32)
    x = ss.pack_state(st)
    p = ss.pack_params(model, params, targets)
    n = ss.state_rows(model.nq)
    for _ in range(10):
        x = host_substep(host_lib, tables, x, p)[:n].contiguous()
    q = x[:18].t().numpy()
    assert q[0, 2] <= hi[0, 2] + 1e-5
    assert q[1, 2] > hi[0, 2] + 1e-3


def test_flops_and_bytes_per_env():
    """The bound's work, term by term, for Bez `stl` over two envs: one with
    no contact active, one with four left-foot points on the ground, the
    ball on the ground in both and against the left-foot box in one."""
    model = bez.load_bez_model("stl")
    tables = ss.KernelTables(model, engine.SceneConfig(substeps=2))
    assert ss.bytes_per_env(model) == 1424      # (229 in + 127 out) floats
    plane = np.zeros(96, np.int64)
    plane[40:44] = 1                            # body 10, left_foot
    box = np.zeros(12, np.int64)
    box[5] = 1                                  # the left_foot box
    foot = np.zeros(19, np.int64)
    foot[10] = 1
    act = ss.ContactActivity(envs=2, plane=plane, ball_plane=2, box=box,
                             damped=foot, loaded=foot.copy())
    per_env = {
        "fk_base_rotation": 35,     # norm 7, 2/n 1, diagonal 9, rest 18
        "fk_bodies": 474,           # 18 x (sin, cos, 2 columns x 9) + 6 x
                                    # 19 nonzero tree_pos entries
        "fk_com": 252,              # 6 x 42 nonzero com entries
        "velocities": 1677,         # base 24, 13 x 96, 5 children of base x 81
        "plane_test": 576,          # 96 points x pw.z (3 products, 3 adds)
        "ball_plane": 1,            # pen = r - z
        "box_test": 468,            # 12 x 29 + 6 x 20 nonzero box_pos
        "ball_gravity": 6,
        "joint_pd_friction": 180,   # 18 x 10
        "jacobian_columns": 666,    # 18 x 3 + 12 x 51 joint columns
        "world_inertia": 1090,      # 19 x 37 + R @ I by nonzero columns
        "wrench": 894,              # base 30 + 18 x 48
        "inertia_times_columns": 1032,  # 19 x 6 + 18 x 51 (undamped)
        "h_entries": 2318,
        "h_accumulate": 541,
        "tau": 948,                 # 19 x 12 + 11 x 51 + 159 adds
        "h_diagonal": 72,
        "cholesky": 1572,
        "substitutions": 672,
        "integrate_joints": 72,
        "integrate_base": 72,       # 12 + 6 + 54 (quaternion step)
        "integrate_ball": 72,       # 18 + 54
    }
    want = {k: 2 * v for k, v in per_env.items()}
    want.update(
        plane_active=4 * (4 * 3 + 81),          # pw.xy + the contact's rest
        ball_plane=2 * (1 + 31),
        box_active=115,
        contact_damped_inertia=29,              # A 4, Bm 7, E 18
        wrench=2 * 894 + 6,                     # + F and N on the foot
        inertia_times_columns=2 * 1032 + 174,   # foot: 288 damped, 114 not
    )
    got = ss.flop_terms(tables, act)
    assert got == {k: want.get(k, 0) for k in got}
    assert set(got) == set(want) | {"plane_active", "box_active",
                                    "contact_damped_inertia"}


def test_bound_without_the_ball():
    """Without a ball the bound counts none of the ball's work: neither its
    13 state rows in and out nor its contact, gravity and integration
    operations.  Its time is the larger of bytes over HBM's rate and
    operations over the fp32 peak."""
    model = bez.load_bez_model("stl")
    cfg = engine.SceneConfig(substeps=4, has_ball=False)
    tables = ss.KernelTables(model, cfg)
    assert ss.bytes_per_env(model, has_ball=False) == 1424 - 2 * 13 * 4
    st, _, _ = _inputs(model, cfg, 16, seed=5, base_z=0.32)
    x = ss.pack_state(st)
    terms = ss.flop_terms(tables, ss.contact_activity(tables, x))
    for k in ("ball_plane", "box_test", "box_active", "ball_gravity",
              "integrate_ball"):
        assert terms[k] == 0, k
    b = ss.bound(tables, x)
    assert b.bytes == 1320 * 16 and b.flops == sum(terms.values())
    t_b = b.bytes / ss.PEAK_BYTES_PER_S * 1e3
    t_o = b.flops / ss.PEAK_FP32_PER_S * 1e3
    assert b.ms == max(t_b, t_o)
    assert b.by == ("bytes" if t_b >= t_o else "operations")
    with_ball = ss.KernelTables(model, engine.SceneConfig(substeps=4))
    assert ss.bound(with_ball, x).bytes == 1424 * 16


def test_contact_activity_matches_the_plain_contacts():
    """Every body the plain substep pushes is counted as loaded, and these
    inputs (feet on the ground, the ball at the left leg, its centre above
    its radius) activate ground and box contacts but not the ball's ground
    contact."""
    model = bez.load_bez_model("stl")
    cfg = engine.SceneConfig(substeps=2)
    tables = ss.KernelTables(model, cfg)
    st, params, targets = _inputs(model, cfg, 64, seed=3, base_z=0.32)
    x = ss.pack_state(st)
    act = ss.contact_activity(tables, x)
    out = ss.substep_plain(tables, x, ss.pack_params(model, params, targets))
    force = out[ss.state_rows(model.nq) + 8:].t().reshape(-1, model.nb, 3)
    pushed = (force.abs().sum(-1) > 0).sum(0).numpy()
    assert (pushed <= act.loaded).all()
    assert (act.damped <= act.loaded).all()
    assert act.plane.sum() > 0 and act.box.sum() > 0 and act.ball_plane == 0
