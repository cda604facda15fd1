"""Build + load the native mesh-cooking library (ctypes).

Compiles meshcook.cpp with g++ on first use into the package's build/native/
directory (git-ignored; never beside the source). Falls back gracefully:
callers check native_available()."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False


def _build_dir() -> str:
    d = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "build", "native")
    os.makedirs(d, exist_ok=True)
    return d


def get_lib():
    """Compile (once) and return the ctypes library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "meshcook.cpp")
        so = os.path.join(_build_dir(), "libmeshcook.so")
        try:
            if (not os.path.exists(so)
                    or os.path.getmtime(so) < os.path.getmtime(src)):
                tmp = f"{so}.{os.getpid()}.tmp"     # processes may build at once
                subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                                "-o", tmp, src], check=True, capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            lib.build_meshlets.restype = ctypes.c_int
            lib.build_meshlets.argtypes = [
                i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, i32p, i32p, i32p, i32p, i32p, i32p]
            lib.simplify_qem.restype = ctypes.c_int
            lib.simplify_qem.argtypes = [
                f32p, ctypes.c_int32, i32p, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_float, i32p,
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def build_meshlets_native(tris: np.ndarray, n_verts: int,
                          max_verts: int, max_tris: int):
    """Greedy meshlet scan in C++ (same contract as the Python scan in
    scene/cooker.py). tris: (T, 3) int32, pre-ordered. Returns the flat
    meshlet arrays or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    tris = np.ascontiguousarray(tris, np.int32)
    T = tris.shape[0]
    cap = max(T, 1)
    vo = np.zeros(cap, np.int32)
    vc = np.zeros(cap, np.int32)
    to = np.zeros(cap, np.int32)
    tc = np.zeros(cap, np.int32)
    mv = np.zeros(cap * 3, np.int32)
    mt = np.zeros(cap * 3, np.int32)
    n = lib.build_meshlets(tris.reshape(-1), np.int32(T), np.int32(n_verts),
                           np.int32(max_verts), np.int32(max_tris),
                           vo, vc, to, tc, mv, mt)
    n_v = int(vo[n - 1] + vc[n - 1]) if n > 0 else 0
    return (vo[:n].copy(), vc[:n].copy(), to[:n].copy(), tc[:n].copy(),
            mv[:n_v].copy(), mt[:T * 3].reshape(-1, 3).copy())


def simplify_qem_native(positions: np.ndarray, tris: np.ndarray,
                        target_tris: int, error_limit: float):
    """Quadric-error-metric simplification in C++ (meshcook.cpp simplify_qem;
    the meshopt_simplifyWithAttributes role, ref src/SceneLoader.cpp:1995-2044).

    positions (V, 3) f32, tris (T, 3) i32 -> (simplified (T', 3) i32,
    max collapse error in object units) or None if native is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    positions = np.ascontiguousarray(positions, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    T = tris.shape[0]
    if T == 0:
        return tris, 0.0
    out = np.zeros((T, 3), np.int32)
    err = np.zeros(1, np.float32)
    n = lib.simplify_qem(positions.reshape(-1), np.int32(positions.shape[0]),
                         tris.reshape(-1), np.int32(T), np.int32(target_tris),
                         np.float32(error_limit), out.reshape(-1), err)
    return out[:n].copy(), float(err[0])
