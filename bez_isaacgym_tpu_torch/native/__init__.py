"""Python bindings for the repo's native C++ components (ctypes)."""

from bez_isaacgym_tpu_torch.native.bindings import (  # noqa: F401
    compile_urdf_native, geometry_lib, is_available, model_lib)
