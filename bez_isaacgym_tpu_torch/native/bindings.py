"""ctypes bindings for the repo's native C++ libraries (`native/`).

Port of `bez_isaacgym_tpu/native/bindings.py`.  The C++ sources in the
repo's root `native/` (a geometry library and a URDF model compiler) are
built unchanged by their own Makefile at first use,
`make -C native BUILD=<build dir> CXXFLAGS=...`, into
`bez_isaacgym_tpu_torch/build/native/` (there is no pybind11, hence
ctypes).  The flags are the Makefile's own plus a private C++ runtime
(`CXXFLAGS` below).  A failed build raises with make's output: nothing
degrades quietly, and nothing stands in for the native URDF compiler when
the build fails.  `is_available()` only says whether the tool chain (make
and a C++ compiler) is there; it builds nothing.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
NATIVE_DIR = PACKAGE_DIR.parent / "native"
BUILD_DIR = PACKAGE_DIR / "build" / "native"
LIBRARIES = ("libbezgeom.so", "libbezmodel.so")
TESTS = ("test_geometry", "test_urdf")
# The Makefile's flags, plus the C++ runtime linked into each library with
# its symbols hidden and the library's own references bound inside it.
# With the shared runtime, the URDF compiler crashed (SIGSEGV) in a process
# that had imported PyTorch built for CUDA, whose libraries export C++
# standard-library symbols, when a compiler other than the one of the
# system's libstdc++ built it (an H100 machine's /opt/gcc g++).
CXXFLAGS = ("-O2 -fPIC -std=c++17 -Wall -Wextra -static-libstdc++ "
            "-static-libgcc -Wl,--exclude-libs,ALL -Wl,-Bsymbolic")


def is_available() -> bool:
    """make and a C++ compiler are on PATH (a probe; it builds nothing)."""
    cxx = os.environ.get("CXX", "g++")
    return bool(shutil.which("make") and shutil.which(cxx))


def make(native_dir: Path, build_dir: Path) -> Path:
    """Build the libraries and the C++ unit tests of `native_dir` into
    `build_dir` with the sources' Makefile; raise with make's output if it
    fails or leaves a library out.  `build_dir` is new, empty, or one that
    this function built before."""
    if not (Path(native_dir) / "Makefile").is_file():
        raise RuntimeError(f"no native sources at {native_dir} (run from a "
                           f"checkout of the repository)")
    if not shutil.which("make"):
        raise RuntimeError("make not found: the native libraries are built "
                           "with make and a C++ compiler at first use")
    build_dir = Path(build_dir).resolve()
    # make does not see a change of flags: a build made with others goes.
    # Only a directory of this module's builds is deleted: one with a stamp,
    # or BUILD_DIR itself.
    stamp = build_dir / "CXXFLAGS"
    if build_dir.exists() and not (stamp.exists()
                                   and stamp.read_text() == CXXFLAGS):
        if stamp.exists() or build_dir == BUILD_DIR:
            shutil.rmtree(build_dir)
        elif any(build_dir.iterdir()):
            raise RuntimeError(f"{build_dir} holds files of no native "
                               f"build: give a new or empty directory")
    proc = subprocess.run(["make", "-C", str(native_dir),
                           f"BUILD={build_dir}", f"CXXFLAGS={CXXFLAGS}"],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed (make exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    missing = [n for n in LIBRARIES + TESTS if not (build_dir / n).exists()]
    if missing:
        raise RuntimeError(f"native build left out {missing}:\n"
                           f"{proc.stdout}{proc.stderr}")
    stamp.write_text(CXXFLAGS)
    return build_dir


@functools.cache
def build() -> Path:
    """Build (or bring up to date) the repo's native libraries, once per
    process."""
    return make(NATIVE_DIR, BUILD_DIR)


@functools.cache
def geometry_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build() / "libbezgeom.so"))
    lib.bez_point3_norm.restype = ctypes.c_float
    lib.bez_point3_norm.argtypes = [ctypes.c_float] * 3
    lib.bez_point3_distance.restype = ctypes.c_float
    lib.bez_point3_distance.argtypes = [ctypes.POINTER(ctypes.c_float)] * 2
    lib.bez_segment3_spaced_points.restype = ctypes.c_int
    lib.bez_segment3_spaced_points.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_float, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.bez_pose3_compose.argtypes = [ctypes.POINTER(ctypes.c_float)] * 3
    lib.bez_pose3_inverse.argtypes = [ctypes.POINTER(ctypes.c_float)] * 2
    return lib


@functools.cache
def model_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build() / "libbezmodel.so"))
    lib.bez_compile_urdf.restype = ctypes.c_int
    lib.bez_compile_urdf.argtypes = [ctypes.c_char_p]
    for name in ("tree_pos", "tree_rot", "axis", "mass", "com", "inertia",
                 "limits"):
        fn = getattr(lib, f"bez_model_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(ctypes.c_double)]
    lib.bez_model_parent.restype = ctypes.c_int
    lib.bez_model_parent.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.bez_model_nq.restype = ctypes.c_int
    for name in ("joint_names", "body_names"):
        fn = getattr(lib, f"bez_model_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int]
    return lib


def compile_urdf_native(path: str) -> dict:
    """Run the native URDF compiler; returns the flat model arrays.

    Native analog of Isaac Gym's `gym.load_asset` (kick_env.py:302); the
    layout matches models/robot.py::build_robot_model's kinematic and
    inertial fields.
    """
    lib = model_lib()
    nb = lib.bez_compile_urdf(str(path).encode())
    if nb <= 0:
        raise ValueError(f"native URDF compile failed for {path}")
    nq = lib.bez_model_nq()

    def fetch(name, shape):
        buf = np.zeros(int(np.prod(shape)), np.float64)
        getattr(lib, f"bez_model_{name}")(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return buf.reshape(shape)

    parent = np.zeros(nb, np.int32)
    lib.bez_model_parent(parent.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    names = ctypes.create_string_buffer(4096)
    lib.bez_model_joint_names(names, len(names))
    joint_names = names.value.decode().split(";") if nq else []
    lib.bez_model_body_names(names, len(names))
    body_names = names.value.decode().split(";")

    return {
        "nb": nb, "nq": nq, "parent": parent,
        "tree_pos": fetch("tree_pos", (nb, 3)),
        "tree_rot": fetch("tree_rot", (nb, 3, 3)),
        "axis": fetch("axis", (nq, 3)),
        "mass": fetch("mass", (nb,)),
        "com": fetch("com", (nb, 3)),
        "inertia": fetch("inertia", (nb, 3, 3)),
        "limits": fetch("limits", (nq, 4)),
        "joint_names": joint_names,
        "body_names": body_names,
    }
