"""Build and bind the package's hand-written CUDA kernels (csrc/*.cu:
K1 and K5 in raster_resolve.cu, K2 restir_candidates.cu, K3 bvh16_walk.cu,
K4 beam_any_hit.cu, K6 closest_blocks.cu, and the step microbenchmarks
K7-K9 in wkernels.cu).

The sources have a plain C interface. At first use each is compiled by its
own ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false`` (all at
once) and the objects are linked into one shared library under
``hobbyrenderer_tpu_torch/build/`` (named by a hash of the sources, so an
edit rebuilds) and loaded with ctypes. Every C entry point
launches on the stream it is given and returns ``cudaGetLastError()``.

``-fmad=false``: no product is contracted into a sum. The plain PyTorch
versions round every product and sum as a separate op, and the kernels keep
their order of operations, so kernel and plain version agree bit for bit.

Nothing here runs at import time: the CPU tests import every module on a
machine with no CUDA toolkit."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
SOURCES = ("raster_resolve.cu", "beam_any_hit.cu", "restir_candidates.cu",
           "bvh16_walk.cu", "closest_blocks.cu", "wkernels.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC")

_lib = None
build_seconds = None     # wall time of the build in this process (None = cached)

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # records, work_tile, work_slot, wcap, tile_start, units, n_units, depth,
    # visid, attrs, keys, done, queue, T, tx, ty0, grid, stream
    "hr_raster_resolve_tiles": (_VP,) * 3 + (_I,) + (_VP,) * 9 + (_I,) * 4 + (_VP,),
    # records, work_tile, work_slot, wcap, tile_start, units, n_units, depth,
    # visid, keys, done, queue, T, tx, ty0, lanes, depth_only, grid, stream
    "hr_raster_tiles": (_VP,) * 3 + (_I,) + (_VP,) * 8 + (_I,) * 6 + (_VP,),
    # work_tile, wcap, T, tile_start, units, n_units, stream
    "hr_raster_plan": (_VP,) + (_I,) * 2 + (_VP,) * 4,
    # n_out
    "hr_raster_ctas_per_sm": (_VP,),
    # rays, table, occ, ovf, list, counters, T, N, I, stream
    "hr_beam_any_hit_tiles": (_VP,) * 6 + (_I,) * 3 + (_VP,),
    # flat3, tsel, planes, cam, y, u, v, w_sum, row, Hp, Wp, T, N, frame, y0,
    # w_log, stream
    "hr_restir_candidates": (_VP,) * 9 + (_I,) * 7 + (_VP,),
    # table, o, d, tmax, best_t, best_tri, steps, queue, R, I, M, any_hit,
    # max_steps, t_min, grid, stream
    "hr_bvh16_walk": (_VP,) * 8 + (_I,) * 5 + (_F, _I, _VP),
    # n_out
    "hr_bvh16_walk_ctas_per_sm": (_VP,),
    # rays, table, t, tri, u, v, front, ovf, work, T, N, I, t_min, stream
    "hr_closest_hit_blocks": (_VP,) * 9 + (_I,) * 3 + (_F, _VP),
    # n_out
    "hr_closest_hit_blocks_max_clusters": (_VP,),
    # idx, leaf, buf, out, checksum, rows, iters, n_leaf, stream
    "hr_wk_leaf_gather": (_VP,) * 5 + (_I,) * 3 + (_VP,),
    # idx, tab, out, checksum, iters, Ip, hc, cluster, cols, pitch, smem, stream
    "hr_wk_int_fetch": (_VP,) * 4 + (_I,) * 7 + (_VP,),
    # hc, cluster, smem, n_out
    "hr_wk_int_fetch_max_clusters": (_I,) * 3 + (_VP,),
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                           "CUDA toolkit on the machine that has the GPU")
    return path


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library: one nvcc
    per source, all started together, then one link."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    paths = [os.path.join(CSRC, s) for s in SOURCES]
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    so = os.path.join(BUILD_DIR, f"libhrkernels_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
        objs = [os.path.join(BUILD_DIR, f"{os.path.splitext(s)[0]}_{tag}.o") for s in SOURCES]
        t0 = time.perf_counter()
        nvcc = _nvcc()
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-Xptxas", "-v", "-o", obj, src],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(paths, objs)]
        logs = []
        for src, pr in zip(SOURCES, procs):
            out, err = pr.communicate()
            if pr.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} ({pr.returncode}):\n{err}")
            logs.append(f"== {src}\n{err}")
        tmp = so + f".{os.getpid()}.tmp"
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, so)
        for obj in objs:
            os.remove(obj)
        build_seconds = time.perf_counter() - t0
        with open(so + ".ptxas.txt", "w") as f:
            f.write("".join(logs))
    lib = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def require(t, name: str, dtype, shape=None):
    """Wrapper-side argument checks: CUDA, dtype, shape, contiguity."""
    if not (isinstance(t, torch.Tensor) and t.is_cuda):
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
