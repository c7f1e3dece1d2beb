"""The port's native bindings (native/bindings.py): the repo's root
`native/` C++ sources built unchanged into the port's build directory, the
C++ unit tests, the geometry bindings (pose compose against scipy) and the
native URDF compiler against the port's Python compiler (`models/urdf.py`
parse + `models/robot.py` build) on every Bez asset variant."""

import ctypes
import subprocess

import numpy as np
import pytest

pytest.importorskip("torch")

from bez_isaacgym_tpu_torch.native import bindings  # noqa: E402

pytestmark = pytest.mark.skipif(not bindings.is_available(),
                                reason="no make or C++ compiler on PATH")


def test_build_goes_into_the_port_build_dir():
    out = bindings.build()
    assert out == bindings.BUILD_DIR.resolve()
    assert out.parent.parent == bindings.PACKAGE_DIR
    for name in bindings.LIBRARIES + bindings.TESTS:
        assert (out / name).is_file(), name


@pytest.mark.parametrize("name", bindings.LIBRARIES)
def test_libraries_carry_their_own_cpp_runtime(name):
    """No shared libstdc++ in a library's NEEDED entries: the runtime is
    linked in with its symbols hidden, so the process's other C++
    libraries (PyTorch's) cannot interpose on it."""
    import shutil

    if not shutil.which("readelf"):
        pytest.skip("no readelf on PATH")
    lib = bindings.build() / name
    out = subprocess.run(["readelf", "-d", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    needed = [ln for ln in out.splitlines() if "(NEEDED)" in ln]
    assert needed and not any("libstdc++" in ln for ln in needed), needed
    syms = subprocess.run(["readelf", "--dyn-syms", "-W", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    assert "GLIBCXX" not in syms


def test_build_made_with_other_flags_is_replaced(tmp_path):
    build = tmp_path / "build"
    build.mkdir()
    (build / "CXXFLAGS").write_text("-O0")
    (build / "stale.o").write_text("")
    (tmp_path / "Makefile").write_text(
        "all:\n\t@mkdir -p $(BUILD)\n"
        + "".join(f"\t@touch $(BUILD)/{n}\n"
                  for n in bindings.LIBRARIES + bindings.TESTS))
    out = bindings.make(tmp_path, build)
    assert not (out / "stale.o").exists()
    assert (out / "CXXFLAGS").read_text() == bindings.CXXFLAGS


def test_build_refuses_a_directory_it_did_not_make(tmp_path):
    """A directory that holds files but no build stamp is not deleted."""
    build = tmp_path / "build"
    build.mkdir()
    (build / "notes.txt").write_text("kept")
    (tmp_path / "Makefile").write_text("all:\n\t@mkdir -p $(BUILD)\n")
    with pytest.raises(RuntimeError, match="no native build"):
        bindings.make(tmp_path, build)
    assert (build / "notes.txt").read_text() == "kept"


@pytest.mark.parametrize("exe", bindings.TESTS)
def test_cpp_unit_tests_pass(exe):
    out = subprocess.run([str(bindings.build() / exe)], capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 failed" in out.stdout


def test_failed_build_raises_with_make_output(tmp_path):
    """A build that fails raises with make's output; nothing falls back."""
    (tmp_path / "Makefile").write_text(
        "all:\n\t@echo broken-on-purpose >&2; exit 3\n")
    with pytest.raises(RuntimeError, match="broken-on-purpose"):
        bindings.make(tmp_path, tmp_path / "build")
    with pytest.raises(RuntimeError, match="no native sources"):
        bindings.make(tmp_path / "missing", tmp_path / "build")


def test_build_that_leaves_a_library_out_raises(tmp_path):
    (tmp_path / "Makefile").write_text("all:\n\t@mkdir -p $(BUILD)\n")
    with pytest.raises(RuntimeError, match="left out"):
        bindings.make(tmp_path, tmp_path / "build")


def test_geometry_bindings():
    lib = bindings.geometry_lib()
    assert abs(lib.bez_point3_norm(3.0, 4.0, 4.0) - 6.4031242) < 1e-5
    a = (ctypes.c_float * 3)(1, 1, 1)
    b = (ctypes.c_float * 3)(2, 2, 2)
    assert abs(lib.bez_point3_distance(a, b) - 1.7320508) < 1e-5
    out = (ctypes.c_float * 99)()
    n = lib.bez_segment3_spaced_points(
        (ctypes.c_float * 3)(1, 1, 1), (ctypes.c_float * 3)(1, 1, 2),
        ctypes.c_float(0.1), out, 33)
    assert n == 11
    zs = [out[3 * i + 2] for i in range(11)]
    np.testing.assert_allclose(zs, 1.0 + 0.1 * np.arange(11), atol=1e-5)


@pytest.mark.parametrize("seed", range(3))
def test_pose_compose_and_inverse_match_scipy(seed):
    from scipy.spatial.transform import Rotation

    lib = bindings.geometry_lib()
    rng = np.random.default_rng(seed)
    for _ in range(5):
        qa = Rotation.random(random_state=rng).as_quat()
        qb = Rotation.random(random_state=rng).as_quat()
        pa, pb = rng.normal(size=3), rng.normal(size=3)
        a = (ctypes.c_float * 7)(*pa, *qa)
        b = (ctypes.c_float * 7)(*pb, *qb)
        out = (ctypes.c_float * 7)()
        lib.bez_pose3_compose(a, b, out)
        want_p = pa + Rotation.from_quat(qa).apply(pb)
        want_q = (Rotation.from_quat(qa) * Rotation.from_quat(qb)).as_quat()
        got = np.array(out[:])
        np.testing.assert_allclose(got[:3], want_p, atol=1e-5)
        sign = np.sign(np.dot(got[3:], want_q))
        np.testing.assert_allclose(got[3:], sign * want_q, atol=1e-5)
        inv = (ctypes.c_float * 7)()
        lib.bez_pose3_inverse(a, inv)
        ra = Rotation.from_quat(qa)
        got = np.array(inv[:])
        np.testing.assert_allclose(got[:3], -ra.inv().apply(pa), atol=1e-5)
        want_q = ra.inv().as_quat()
        sign = np.sign(np.dot(got[3:], want_q))
        np.testing.assert_allclose(got[3:], sign * want_q, atol=1e-5)


@pytest.mark.parametrize("variant", ["stl", "box", "box_sensor",
                                     "stl_sensor"])
def test_native_urdf_compiler_matches_the_ports_python_compiler(
        variant, tmp_path):
    """The C++ compiler and the port's Python URDF compile give identical
    flat models for the real Bez robot (JSON asset -> URDF -> both)."""
    from bez_isaacgym_tpu_torch.models.bez import load_spec
    from bez_isaacgym_tpu_torch.models.robot import build_robot_model
    from bez_isaacgym_tpu_torch.models.urdf import parse_urdf

    text = load_spec(variant).to_urdf()
    path = tmp_path / f"bez_{variant}.urdf"
    path.write_text(text)
    native = bindings.compile_urdf_native(str(path))
    py_model = build_robot_model(parse_urdf(text))

    assert native["nb"] == py_model.nb
    assert native["nq"] == py_model.nq
    assert native["joint_names"] == py_model.joint_names
    assert native["body_names"] == py_model.body_names
    np.testing.assert_array_equal(native["parent"], py_model.parent)
    for key in ("tree_pos", "tree_rot", "axis", "mass", "com", "inertia"):
        np.testing.assert_allclose(native[key], getattr(py_model, key),
                                   atol=1e-12, err_msg=key)
    for col, key in ((0, "dof_lower"), (1, "dof_upper"), (2, "dof_effort"),
                     (3, "dof_velocity")):
        np.testing.assert_allclose(native["limits"][:, col],
                                   getattr(py_model, key), atol=1e-12,
                                   err_msg=key)

