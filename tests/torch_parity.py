"""Shared set-up of the port's parity tests (tests/test_torch_*.py)."""

import os
import shutil

from hobbyrenderer_tpu.native import build as jax_native
from hobbyrenderer_tpu_torch.native import build as torch_native


def same_mesh_cooker():
    """Make both packages cook meshes the same way in this process: with
    their native library (meshcook.cpp), or both without it.

    The JAX package compiles its library on first use straight into its
    source directory. When several test processes start at once, one of
    them can load the file while another's g++ is still writing it; the
    load fails, and from then on that process cooks every mesh with the
    Python fallback, whose LOD chains differ from the native ones (stress:2:
    4 LODs of a mesh instead of 7, 23,258 triangles instead of 33,572). Its
    scenes then differ from the port's. Here such a process builds the JAX
    package's library once more, alone, in a private directory of the
    port's git-ignored build tree, and loads it."""
    if jax_native.get_lib() is None and torch_native.get_lib() is not None:
        private = os.path.join(torch_native._build_dir(), f"jax_meshcook.{os.getpid()}")
        old = os.environ.get("HR_NATIVE_DIR")
        os.environ["HR_NATIVE_DIR"] = private
        try:
            jax_native._tried = False
            jax_native.get_lib()
        finally:
            if old is None:
                del os.environ["HR_NATIVE_DIR"]
            else:
                os.environ["HR_NATIVE_DIR"] = old
            shutil.rmtree(private, ignore_errors=True)    # the loaded library stays mapped
    assert (jax_native.get_lib() is None) == (torch_native.get_lib() is None), \
        "one package cooks meshes natively and the other in Python"
