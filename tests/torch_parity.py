"""Shared set-up of the port's parity tests (tests/test_torch_*.py)."""

import dataclasses
import functools
import importlib
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
from hobbyrenderer_tpu_torch.ops import envmap as tenv
from hobbyrenderer_tpu_torch.ops import restir as trestir
from hobbyrenderer_tpu_torch.ops import trace as ttrace
from hobbyrenderer_tpu_torch.renderer import Renderer as TorchRenderer
from hobbyrenderer_tpu_torch.scene.workload import animate_nodes


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


def animated_stress_scenes(grid: int, every: int):
    """stress:grid built by each package, with the same node animations
    (scene/workload.py::animate_nodes on the port's, copied onto the JAX
    package's classes): (JAX scene, port scene)."""
    jmod = importlib.import_module("hobbyrenderer_tpu.scene.scene")
    jscene = importlib.import_module("hobbyrenderer_tpu.scene").make_stress_scene(grid=grid)
    tscene = animate_nodes(importlib.import_module(
        "hobbyrenderer_tpu_torch.scene.procedural").make_stress_scene(grid=grid), every=every)
    for a in tscene.animations:
        jscene.animations.append(jmod.Animation(
            name=a.name, duration=a.duration,
            channels=[jmod.AnimationChannel(**dataclasses.asdict(c)) for c in a.channels]))
    return jscene, tscene


def emissive_pulse_scene(package: str):
    """tests/test_loader.py::test_animated_emissive_relights_scene_e2e's
    scene, built with ``package``'s classes ("hobbyrenderer_tpu" or
    "hobbyrenderer_tpu_torch"): a floor under an emissive quad whose
    strength ramps 1 -> 30 over 2 s, a zero-power sun, one camera."""
    sm = importlib.import_module(f"{package}.scene.scene")
    cook_mesh = importlib.import_module(f"{package}.scene.cooker").cook_mesh
    proc = importlib.import_module(f"{package}.scene.procedural")
    sc = sm.Scene()
    floor = sc.add_material(sm.Material(
        name="floor", base_color=np.array([0.6, 0.6, 0.6, 1], np.float32), roughness=0.9,
        double_sided=True))
    lamp = sc.add_material(sm.Material(
        name="lamp", emissive=np.array([4.0, 4.0, 4.0], np.float32), emissive_strength=1.0,
        double_sided=True))
    pos, nrm, uv, idx = proc.plane_geometry(3.0)
    fp = sc.add_mesh(cook_mesh(pos, idx, normals=nrm, uvs=uv), material=floor)
    sc.add_node(sm.Node(name="floor", mesh_primitives=[fp]))
    qpos, qnrm, quv, qidx = proc.plane_geometry(1.0)
    lp = sc.add_mesh(cook_mesh(qpos, qidx, normals=-qnrm, uvs=quv), material=lamp)
    sc.add_node(sm.Node(name="lamp", mesh_primitives=[lp],
                        translation=np.array([0, 2.0, 0], np.float32)))
    sc.add_light(sm.Light(type=sm.LIGHT_DIRECTIONAL, direction=np.array([0, -1, 0], np.float32),
                          intensity=0.0))
    sc.cameras.append(proc.camera_looking_at(np.array([0, 1.0, 3.0], np.float32), np.zeros(3)))
    sc.animations.append(sm.Animation(
        name="pulse", duration=2.0,
        channels=[sm.AnimationChannel(target_material=lamp, path="emissiveIntensity",
                                      times=np.asarray([0.0, 2.0], np.float32),
                                      values=np.asarray([[1.0], [30.0]], np.float32))]))
    sc.finalize()
    return sc


def frames_beside_jax(kw, frames: int, lift_caps: bool = True, jax_keep=(), scenes=None,
                      dt: float = 1.0 / 60.0, lift_walk_budgets: bool = False):
    """Render ``frames`` frames of one config in both packages on the CPU:
    the port's Renderer on a second thread while XLA compiles the JAX frame
    (most of the time), so a file that runs one JAX Renderer stays short.
    ``lift_caps`` lifts RTXDI's straggler capacity and step cap on the
    port's side (the JAX CPU frame traces winner visibility exactly).
    ``jax_keep`` names JAX frame resources to keep, as numpy, per frame in
    the JAX Renderer's ``kept`` list, with its persistent state before the
    frame under "state_before" and after it under "state_after".
    ``scenes``: (JAX scene, port scene) to render instead of kw["scene"];
    ``dt``: the frame step (animations advance by it).
    ``lift_walk_budgets`` runs every capped K3 walk of the port uncapped
    (ROADMAP Queue 3, "K3's budgets on capped calls"). With
    kw["keep_hdr"], the port's stats of a frame also carry "hdr_mean", the
    mean of its linear HDR frame. Returns (JAX
    Renderer, port Renderer, JAX LDR frames, port LDR frames, the port's
    stats per frame)."""
    jscene, tscene = scenes or (None, None)
    if kw.get("envmap"):
        # decode once here: both packages then read the same .npy cache
        tenv.load_envmap(kw["envmap"])

    def port():
        torch.set_num_threads(1)      # a thread's own setting: not inherited
        tr = TorchRenderer(Config(**kw), scene=tscene, device="cpu")
        ldr, stats = [], []
        for _ in range(frames):
            ldr.append(tr.render_frame(dt).numpy())
            stats.append(tr.stats())
            if kw.get("keep_hdr"):
                stats[-1]["hdr_mean"] = float(tr._model.last_resources["hdr"].mean())
        tr.shutdown()
        return tr, ldr, stats

    restir_di, walk_steps = trestir.restir_di, ttrace._walk_steps
    if lift_caps:
        trestir.restir_di = functools.partial(restir_di, straggler_steps=None)
    if lift_walk_budgets:
        ttrace._walk_steps = lambda max_steps: None
    try:
        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(port)
            jr = JaxRenderer(JaxConfig(**kw), scene=jscene)
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
                ldr_j.append(np.asarray(jr.render_frame(dt)))
                if jax_keep:
                    jr.kept.append(dict(jax.tree_util.tree_map(
                        np.asarray, {k: jr._model.last_stats[k] for k in jax_keep}),
                        state_before=before,
                        state_after=jax.tree_util.tree_map(np.array, jr._model.state)))
            jr.shutdown()
            tr, ldr_t, stats = fut.result()
    finally:
        trestir.restir_di, ttrace._walk_steps = restir_di, walk_steps
    return jr, tr, ldr_j, ldr_t, stats


def ldr_agreement(lj, lt):
    """(share of pixels within 2/255 on every channel, mean |delta|, max)."""
    assert lt.shape == lj.shape and lt.dtype == np.uint8
    diff = np.abs(lj.astype(np.int32) - lt.astype(np.int32))
    return float(np.mean(diff.max(-1) <= 2)), float(diff.mean()), int(diff.max())
