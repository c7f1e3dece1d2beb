"""The port's ops against the JAX package's, function by function.

quat, kinematics, dynamics, contact, linalg and sensors on the full Bez
`stl` model (19 bodies, 18 DOFs, 96 contact points, 12 boxes, the ball) at
B=4 envs.  Inputs come from a seeded numpy RNG; the JAX side runs as ONE
jitted program (vmapped over the envs) so the file costs one compile, and
each output is its own test case.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bez_isaacgym_tpu.models import bez as jbez  # noqa: E402
from bez_isaacgym_tpu.ops import contact as jct  # noqa: E402
from bez_isaacgym_tpu.ops import dynamics as jdyn  # noqa: E402
from bez_isaacgym_tpu.ops import kinematics as jkin  # noqa: E402
from bez_isaacgym_tpu.ops import linalg as jla  # noqa: E402
from bez_isaacgym_tpu.ops import quat as jq  # noqa: E402
from bez_isaacgym_tpu.ops import sensors as jsens  # noqa: E402
from bez_isaacgym_tpu_torch.models import bez  # noqa: E402
from bez_isaacgym_tpu_torch.ops import contact as ct  # noqa: E402
from bez_isaacgym_tpu_torch.ops import dynamics as dyn  # noqa: E402
from bez_isaacgym_tpu_torch.ops import kinematics as kin  # noqa: E402
from bez_isaacgym_tpu_torch.ops import linalg as la  # noqa: E402
from bez_isaacgym_tpu_torch.ops import quat as q  # noqa: E402
from bez_isaacgym_tpu_torch.ops import sensors as sens  # noqa: E402

B = 4
COEFFS = dict(kn=6000.0, cn=60.0, vt_eps=0.02, ball_kn=3000.0, ball_cn=8.0)
RADIUS, ROLLING = 0.08, 0.01


def _inputs():
    rng = np.random.default_rng(0)
    f = np.float32

    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(f)

    m = jbez.load_bez_model("stl")
    q0 = jbez.pose_vector(m, jbez.READY_JOINT_ANGLES)
    quat_small = unit(np.concatenate(
        [rng.normal(0, 0.05, (B, 3)), np.ones((B, 1))], -1))
    x = dict(
        qa=unit(rng.normal(size=(B, 4))), qb=unit(rng.normal(size=(B, 4))),
        v=rng.normal(size=(B, 3)).astype(f),
        axis=unit(rng.normal(size=(B, 3))),
        ang=rng.uniform(-3, 3, B).astype(f),
        rpy=rng.uniform(-1.5, 1.5, (B, 3)).astype(f),
        t=rng.uniform(0, 1, (B, 1)).astype(f),
        lo=rng.uniform(-2, -1, (B, 3)).astype(f),
        hi=rng.uniform(1, 2, (B, 3)).astype(f),
        q=(q0 + rng.uniform(-0.1, 0.1, (B, 18))).astype(f),
        qd=rng.uniform(-1, 1, (B, 18)).astype(f),
        base_pos=np.tile([0.0, 0.0, 0.318], (B, 1)).astype(f)
        + rng.uniform(-0.005, 0.005, (B, 3)).astype(f),
        base_quat=quat_small,
        base_u=rng.uniform(-0.3, 0.3, (B, 6)).astype(f),
        mass_scale=rng.uniform(0.8, 1.2, (B, 19)).astype(f),
        mu=rng.uniform(0.7, 1.3, B).astype(f),
        ball_vel=rng.uniform(-1, 1, (B, 3)).astype(f),
        ball_ang=rng.uniform(-3, 3, (B, 3)).astype(f),
        ball_off=rng.uniform(-0.02, 0.02, (B, 3)).astype(f),
        targets=(q0 + rng.uniform(-0.3, 0.3, (B, 18))).astype(f),
        armature=np.full((B, 18), 1e-3, f),
        Hm=rng.normal(size=(B, 24, 24)).astype(f),
        bvec=rng.normal(size=(B, 24)).astype(f),
        force=rng.normal(0, 2, (B, 2, 3)).astype(f),
        sensor=rng.uniform(0, 3, (B, 8)).astype(f),
        goal=rng.uniform(-2, 2, (B, 2)).astype(f),
    )
    # An SPD, badly scaled system like the mass matrix.
    A = x["Hm"]
    x["Hspd"] = (A @ np.swapaxes(A, 1, 2) * np.logspace(-3, 0, 24)[None, :]
                 + np.eye(24)[None] * 1e-2).astype(f)
    x["Hspd"] = 0.5 * (x["Hspd"] + np.swapaxes(x["Hspd"], 1, 2))
    # Contact-rich: feet through the plane; the ball against the left foot.
    lf = m.body_index("left_foot")
    frames = jax.vmap(lambda a, b, c: jkin.forward_kinematics(m, a, b, c))(
        jnp.asarray(x["q"]), jnp.asarray(x["base_pos"]),
        jnp.asarray(x["base_quat"]))
    x["ball_pos"] = (np.asarray(frames.com[:, lf]) + np.array(
        [0.09, 0.0, 0.0], f) + x["ball_off"]).astype(f)
    return x


def _jax_outputs(m, x):
    mask = jkin.ancestor_mask(m)
    co = jct.ContactCoeffs(**COEFFS)

    def per_env(e):
        fr = jkin.forward_kinematics(m, e["q"], e["base_pos"], e["base_quat"])
        J_lin, J_ang = jkin.com_jacobians(m, fr, mask)
        u = jnp.concatenate([e["base_u"], e["qd"]])
        vel = jdyn.body_velocities(J_lin, J_ang, u)
        mm, I_w = jdyn.world_inertias(m, fr, e["mass_scale"])
        al0, a0 = jdyn.bias_accelerations(m, fr, vel, e["qd"])
        grav = jnp.array([0.0, 0.0, -9.81])
        wr = jct.robot_plane_contacts(m, fr, vel, e["mu"], co)
        wr2, bf = jct.ball_robot_contacts(m, fr, vel, e["ball_pos"],
                                          e["ball_vel"], e["ball_ang"],
                                          RADIUS, e["mu"], co)
        bp = jct.ball_plane_contact(e["ball_pos"] - jnp.array([0, 0, 0.01]),
                                    e["ball_vel"], e["ball_ang"], RADIUS,
                                    e["mu"], ROLLING, co)
        imu, prev = jsens.compute_imu(e["base_quat"], e["base_u"][:3],
                                      e["base_u"][3:], e["v"], 1 / 60)
        return {
            "fk_rot": fr.rot, "fk_pos": fr.pos, "fk_com": fr.com,
            "fk_axis": fr.axis_w, "fk_anchor": fr.anchor,
            "J_lin": J_lin, "J_ang": J_ang,
            "point_jac": jkin.point_jacobian(J_lin[5], J_ang[5], e["v"],
                                             fr.com[5]),
            "vel_w": vel.w, "vel_v": vel.v_com, "mass": mm, "I_w": I_w,
            "alpha0": al0, "a_com0": a0,
            "mass_matrix": jdyn.mass_matrix(J_lin, J_ang, mm, I_w,
                                            e["armature"]),
            "bias_force": jdyn.bias_force(J_lin, J_ang, mm, I_w, vel, al0,
                                          a0, grav),
            "wrench_gen": jdyn.body_wrench_to_generalized(J_lin, J_ang,
                                                          wr.F, wr.N),
            "pd_torque": jdyn.pd_torque(e["q"], e["qd"], e["targets"],
                                        100.0, 7.5, 2.5, 0.1),
            "plane_F": wr.F, "plane_N": wr.N, "plane_sensor":
            wr.sensor_normal, "ballbox_F": wr2.F, "ballbox_N": wr2.N,
            "ball_F": bf.F, "ball_N": bf.N, "ballplane_F": bp.F,
            "ballplane_N": bp.N,
            "imu": imu, "imu_prev": prev,
            "off_orn": jsens.compute_off_orn(e["base_pos"], e["qa"],
                                             e["goal"]),
            "feet_cleats": jsens.feet_sensors_cleats(e["sensor"] - 1.5),
            "feet_no_cleats": jsens.feet_sensors_no_cleats(e["force"][0],
                                                           e["force"][1]),
        }

    out = jax.vmap(per_env)({k: jnp.asarray(v) for k, v in x.items()})
    qa, qb, v = x["qa"], x["qb"], x["v"]
    out.update({
        "quat_unit": jq.quat_unit(3.0 * qa),
        "quat_conjugate": jq.quat_conjugate(qa),
        "quat_mul": jq.quat_mul(qa, qb),
        "quat_rotate": jq.quat_rotate(qa, v),
        "quat_rotate_inverse": jq.quat_rotate_inverse(qa, v),
        "quat_axis": jnp.stack([jq.quat_axis(qa, i) for i in range(3)]),
        "get_basis_vector": jq.get_basis_vector(qa, v),
        "quat_to_matrix": jq.quat_to_matrix(qa),
        "imu_rotation_matrix": jq.imu_rotation_matrix(qa),
        "matrix_to_quat": jq.matrix_to_quat(jq.quat_to_matrix(qa)),
        "quat_from_axis_angle": jq.quat_from_axis_angle(x["axis"], x["ang"]),
        "quat_from_euler_xyz": jq.quat_from_euler_xyz(*x["rpy"].T),
        "get_euler_xyz": jnp.stack(jq.get_euler_xyz(qa)),
        "normalize_angle": jq.normalize_angle(3 * x["ang"]),
        "quat_diff_rad": jq.quat_diff_rad(qa, qb),
        "quat_integrate": jq.quat_integrate(qa, v, 1 / 120),
        "quat_slerp": jq.quat_slerp(qa, qb, x["t"]),
        "scale_transform": jq.scale_transform(v, x["lo"], x["hi"]),
        "unscale_transform": jq.unscale_transform(v, x["lo"], x["hi"]),
        "saturate": jq.saturate(v, x["lo"], x["hi"]),
        "local_to_world_space": jq.local_to_world_space(v, x["hi"], qa),
        "cholesky_solve": jla.batched_cholesky_solve(x["Hspd"], x["bvec"]),
        "solve_spd_ordered": jla.solve_spd_ordered(
            x["Hspd"], x["bvec"],
            np.concatenate([np.arange(6, 24), np.arange(6)])),
    })
    return out


def _torch_outputs(m, x):
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    mask = kin.ancestor_mask(m)
    co = ct.ContactCoeffs(**COEFFS)
    fr = kin.forward_kinematics(m, t["q"], t["base_pos"], t["base_quat"])
    J_lin, J_ang = kin.com_jacobians(m, fr, mask)
    u = torch.cat([t["base_u"], t["qd"]], -1)
    vel = dyn.body_velocities(J_lin, J_ang, u)
    mm, I_w = dyn.world_inertias(m, fr, t["mass_scale"])
    al0, a0 = dyn.bias_accelerations(m, fr, vel, t["qd"])
    grav = torch.tensor([0.0, 0.0, -9.81])
    wr = ct.robot_plane_contacts(m, fr, vel, t["mu"], co)
    wr2, bf = ct.ball_robot_contacts(m, fr, vel, t["ball_pos"], t["ball_vel"],
                                     t["ball_ang"], RADIUS, t["mu"], co)
    bp = ct.ball_plane_contact(t["ball_pos"] - torch.tensor([0, 0, 0.01]),
                               t["ball_vel"], t["ball_ang"], RADIUS, t["mu"],
                               ROLLING, co)
    imu, prev = sens.compute_imu(t["base_quat"], t["base_u"][:, :3],
                                 t["base_u"][:, 3:], t["v"], 1 / 60)
    qa, qb, v = t["qa"], t["qb"], t["v"]
    return {
        "fk_rot": fr.rot, "fk_pos": fr.pos, "fk_com": fr.com,
        "fk_axis": fr.axis_w, "fk_anchor": fr.anchor,
        "J_lin": J_lin, "J_ang": J_ang,
        "point_jac": kin.point_jacobian(J_lin[:, 5], J_ang[:, 5], v,
                                        fr.com[:, 5]),
        "vel_w": vel.w, "vel_v": vel.v_com, "mass": mm, "I_w": I_w,
        "alpha0": al0, "a_com0": a0,
        "mass_matrix": dyn.mass_matrix(J_lin, J_ang, mm, I_w, t["armature"]),
        "bias_force": dyn.bias_force(J_lin, J_ang, mm, I_w, vel, al0, a0,
                                     grav),
        "wrench_gen": dyn.body_wrench_to_generalized(J_lin, J_ang, wr.F,
                                                     wr.N),
        "pd_torque": dyn.pd_torque(t["q"], t["qd"], t["targets"],
                                   torch.tensor(100.0), torch.tensor(7.5),
                                   torch.tensor(2.5), torch.tensor(0.1)),
        "plane_F": wr.F, "plane_N": wr.N, "plane_sensor": wr.sensor_normal,
        "ballbox_F": wr2.F, "ballbox_N": wr2.N, "ball_F": bf.F,
        "ball_N": bf.N, "ballplane_F": bp.F, "ballplane_N": bp.N,
        "imu": imu, "imu_prev": prev,
        "off_orn": sens.compute_off_orn(t["base_pos"], qa, t["goal"]),
        "feet_cleats": sens.feet_sensors_cleats(t["sensor"] - 1.5),
        "feet_no_cleats": sens.feet_sensors_no_cleats(t["force"][:, 0],
                                                      t["force"][:, 1]),
        "quat_unit": q.quat_unit(3.0 * qa),
        "quat_conjugate": q.quat_conjugate(qa),
        "quat_mul": q.quat_mul(qa, qb),
        "quat_rotate": q.quat_rotate(qa, v),
        "quat_rotate_inverse": q.quat_rotate_inverse(qa, v),
        "quat_axis": torch.stack([q.quat_axis(qa, i) for i in range(3)]),
        "get_basis_vector": q.get_basis_vector(qa, v),
        "quat_to_matrix": q.quat_to_matrix(qa),
        "imu_rotation_matrix": q.imu_rotation_matrix(qa),
        "matrix_to_quat": q.matrix_to_quat(q.quat_to_matrix(qa)),
        "quat_from_axis_angle": q.quat_from_axis_angle(t["axis"], t["ang"]),
        "quat_from_euler_xyz": q.quat_from_euler_xyz(*t["rpy"].T),
        "get_euler_xyz": torch.stack(q.get_euler_xyz(qa)),
        "normalize_angle": q.normalize_angle(3 * t["ang"]),
        "quat_diff_rad": q.quat_diff_rad(qa, qb),
        "quat_integrate": q.quat_integrate(qa, v, 1 / 120),
        "quat_slerp": q.quat_slerp(qa, qb, t["t"]),
        "scale_transform": q.scale_transform(v, t["lo"], t["hi"]),
        "unscale_transform": q.unscale_transform(v, t["lo"], t["hi"]),
        "saturate": q.saturate(v, t["lo"], t["hi"]),
        "local_to_world_space": q.local_to_world_space(v, t["hi"], qa),
        "cholesky_solve": la.batched_cholesky_solve(t["Hspd"], t["bvec"]),
        "solve_spd_ordered": la.solve_spd_ordered(
            t["Hspd"], t["bvec"],
            np.concatenate([np.arange(6, 24), np.arange(6)])),
    }


# Outputs whose values are forces from the kn=6000 N/m penalty springs (up
# to ~100 N) or an f32 solve of a matrix with condition ~1e5: relative bars.
# The rest are unit-scale geometry and kinematics: 1e-5 absolute covers f32
# rounding of chained 3x3 products over the 6-deep leg chains.
RTOL = {"plane_F": 1e-4, "plane_N": 1e-4, "plane_sensor": 1e-4,
        "ballbox_F": 1e-4, "ballbox_N": 1e-4, "ball_F": 1e-4, "ball_N": 1e-4,
        "ballplane_F": 1e-4, "ballplane_N": 1e-4, "wrench_gen": 1e-4,
        "cholesky_solve": 1e-3, "solve_spd_ordered": 1e-3, "imu": 1e-5,
        "bias_force": 1e-5}
ATOL = {"plane_F": 1e-3, "plane_N": 1e-4, "plane_sensor": 1e-3,
        "ballbox_F": 1e-3, "ballbox_N": 1e-4, "ball_F": 1e-3,
        "ball_N": 1e-4, "ballplane_F": 1e-3, "ballplane_N": 1e-4,
        "wrench_gen": 1e-3, "cholesky_solve": 1e-3,
        "solve_spd_ordered": 1e-3, "imu": 1e-4, "bias_force": 1e-4}

NAMES = [
    "fk_rot", "fk_pos", "fk_com", "fk_axis", "fk_anchor", "J_lin", "J_ang",
    "point_jac", "vel_w", "vel_v", "mass", "I_w", "alpha0", "a_com0",
    "mass_matrix", "bias_force", "wrench_gen", "pd_torque", "plane_F",
    "plane_N", "plane_sensor", "ballbox_F", "ballbox_N", "ball_F", "ball_N",
    "ballplane_F", "ballplane_N", "imu", "imu_prev", "off_orn",
    "feet_cleats", "feet_no_cleats", "quat_unit", "quat_conjugate",
    "quat_mul", "quat_rotate", "quat_rotate_inverse", "quat_axis",
    "get_basis_vector", "quat_to_matrix", "imu_rotation_matrix",
    "matrix_to_quat", "quat_from_axis_angle", "quat_from_euler_xyz",
    "get_euler_xyz", "normalize_angle", "quat_diff_rad", "quat_integrate",
    "quat_slerp", "scale_transform", "unscale_transform", "saturate",
    "local_to_world_space", "cholesky_solve", "solve_spd_ordered",
]


@pytest.fixture(scope="module")
def outputs():
    x = _inputs()
    jm = jbez.load_bez_model("stl")
    ref = jax.jit(lambda d: _jax_outputs(jm, d))(x)
    got = _torch_outputs(bez.load_bez_model("stl"), x)
    return {k: np.asarray(v) for k, v in ref.items()}, \
        {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("name", NAMES)
def test_op_matches_jax(outputs, name):
    ref, got = outputs
    assert got[name].shape == ref[name].shape, name
    np.testing.assert_allclose(got[name], ref[name],
                               rtol=RTOL.get(name, 1e-5),
                               atol=ATOL.get(name, 1e-5))


def test_contacts_are_engaged(outputs):
    """The inputs exercise every contact path: feet on the plane, the ball
    against a foot box and the plane."""
    _, got = outputs
    assert np.abs(got["plane_F"]).max() > 1.0
    assert np.abs(got["ballbox_F"]).max() > 0.1
    assert np.abs(got["ballplane_F"]).max() > 0.1


def test_ancestor_mask_matches_jax():
    np.testing.assert_array_equal(
        kin.ancestor_mask(bez.load_bez_model("stl")),
        jkin.ancestor_mask(jbez.load_bez_model("stl")))
