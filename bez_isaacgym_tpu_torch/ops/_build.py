"""Build and load the CUDA substep kernel of `csrc/` at first use.

`nvcc` compiles `csrc/substep.cu` into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), cached under
`build/` by a hash of the sources and flags.  The library is loaded with
ctypes.  Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

# Full IEEE sinf/cosf/sqrtf/division: no --use_fast_math.  -Xptxas -v
# reports registers and local-memory spills into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# The .cu the library is built from, then every file that feeds it.
SOURCES = ("substep.cu", "substep_body.cuh")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernel is built from csrc/ at first use")


def library_path() -> Path:
    """Path of the built library, keyed by sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update((CSRC_DIR / src).read_bytes())
    return BUILD_DIR / f"libsubstep_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless one for the current sources exists."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[0])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[0]}:\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def build_log() -> str:
    """The compiler's report (registers, spills) for the built library."""
    return library_path().with_suffix(".log").read_text()


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its C entries."""
    lib = ctypes.CDLL(str(build()))
    lib.bez_substep_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.bez_substep_launch.restype = ctypes.c_int
    lib.bez_substep_config.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.bez_substep_config.restype = ctypes.c_int
    lib.bez_substep_tables_size.argtypes = []
    lib.bez_substep_tables_size.restype = ctypes.c_int
    return lib
