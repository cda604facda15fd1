"""Shared set-up of the port's parity tests (tests/test_torch_*.py)."""

import functools
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import torch

from hobbyrenderer_tpu.config import Config as JaxConfig
from hobbyrenderer_tpu.graph.rendergraph import FrameContext
from hobbyrenderer_tpu.native import build as jax_native
from hobbyrenderer_tpu.renderer import Renderer as JaxRenderer
from hobbyrenderer_tpu_torch.config import Config
from hobbyrenderer_tpu_torch.native import build as torch_native
from hobbyrenderer_tpu_torch.ops import restir as trestir
from hobbyrenderer_tpu_torch.renderer import Renderer as TorchRenderer


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


def frames_beside_jax(kw, frames: int, lift_caps: bool = True, jax_keep=()):
    """Render ``frames`` frames of one config in both packages on the CPU:
    the port's Renderer on a second thread while XLA compiles the JAX frame
    (most of the time), so a file that runs one JAX Renderer stays short.
    ``lift_caps`` lifts RTXDI's straggler capacity and step cap on the
    port's side (the JAX CPU frame traces winner visibility exactly).
    ``jax_keep`` names JAX frame resources to keep, as numpy, per frame in
    the JAX Renderer's ``kept`` list, with its persistent state before the
    frame under "state_before" and after it under "state_after". Returns
    (JAX Renderer, port Renderer, JAX LDR frames, port LDR frames, the
    port's stats per frame)."""
    def port():
        torch.set_num_threads(1)      # a thread's own setting: not inherited
        tr = TorchRenderer(Config(**kw), device="cpu")
        ldr, stats = [], []
        for _ in range(frames):
            ldr.append(tr.render_frame().numpy())
            stats.append(tr.stats())
        tr.shutdown()
        return tr, ldr, stats

    restir_di = trestir.restir_di
    if lift_caps:
        trestir.restir_di = functools.partial(restir_di, straggler_steps=None)
    try:
        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(port)
            jr = JaxRenderer(JaxConfig(**kw))
            jr.kept = []
            if jax_keep:
                m = jr._model

                def fn(gpu, rt, vc, settings, state, dt):
                    ctx = FrameContext(gpu=gpu, vc=vc, settings=settings, config=m.config,
                                       dt=dt, rt=rt)
                    out = m.graph.execute(ctx, state, outputs=("ldr", "raster_overflow")
                                          + tuple(jax_keep))
                    o = out["outputs"]
                    return o["ldr"], {k: o[k] for k in ("raster_overflow",) + tuple(jax_keep)}, \
                        out["state"]

                m._jitted = jax.jit(fn, donate_argnums=(4,))
            ldr_j = []
            for _ in range(frames):
                before = jax.tree_util.tree_map(np.array, jr._model.state)
                ldr_j.append(np.asarray(jr.render_frame()))
                if jax_keep:
                    jr.kept.append(dict(jax.tree_util.tree_map(
                        np.asarray, {k: jr._model.last_stats[k] for k in jax_keep}),
                        state_before=before,
                        state_after=jax.tree_util.tree_map(np.array, jr._model.state)))
            jr.shutdown()
            tr, ldr_t, stats = fut.result()
    finally:
        trestir.restir_di = restir_di
    return jr, tr, ldr_j, ldr_t, stats


def ldr_agreement(lj, lt):
    """(share of pixels within 2/255 on every channel, mean |delta|, max)."""
    assert lt.shape == lj.shape and lt.dtype == np.uint8
    diff = np.abs(lj.astype(np.int32) - lt.astype(np.int32))
    return float(np.mean(diff.max(-1) <= 2)), float(diff.mean()), int(diff.max())
