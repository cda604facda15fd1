"""Top-level Renderer: scene, camera, frame graph and frame loop on an
explicit torch device (counterpart of hobbyrenderer_tpu/renderer.py).

Ported: the deferred frame in the Normal, IBL and NormalBasic modes with
simple direct lighting or ReSTIR DI (``direct_mode="restir"``, every
``restir_quality`` preset, both denoisers, with or without ``regir`` in
either ``regir_mode``) and every ``indirect_mode`` (none, sharc, ssgi,
restir, ddgi, combined; traced specular unless ``specular_indirect`` is
off), each pass run where the JAX package runs it (restir + restir in
Normal mode is the flagship frame), and the reference path tracer
(``mode="path_tracer"``, progressive, ``pt_spp`` samples a frame). Every
other option raises NotImplementedError naming the ROADMAP Queue 1 item
that brings it."""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from hobbyrenderer_tpu_torch.config import Config, RenderingMode
from hobbyrenderer_tpu_torch.scene.camera import Camera
from hobbyrenderer_tpu_torch.scene.procedural import make_default_cube_scene, make_stress_scene
from hobbyrenderer_tpu_torch.scene.camera_state import CameraStateManager
from hobbyrenderer_tpu_torch.utils import math as hm
from hobbyrenderer_tpu_torch.utils.image import write_png
from hobbyrenderer_tpu_torch.utils.timing import PROFILER
from hobbyrenderer_tpu_torch.models.deferred import DeferredRenderer, pass_gates
from hobbyrenderer_tpu_torch.models.pathtracer import PathTracerRenderer
from hobbyrenderer_tpu_torch.models.scene_rt import build_scene_rt
from hobbyrenderer_tpu_torch.scene.gpu import build_scene_gpu, update_instance_transforms

_ENV = "ROADMAP Queue 1 item 5 (environment maps and authored IBL)"
_ANIM = "ROADMAP Queue 1 item 6 (animated scenes: the per-frame refit)"
_OPTIONS = "ROADMAP Queue 1 item 7 (TAA upscaling and the remaining options)"
_DEBUG = "ROADMAP Queue 1 item 8 (debug views)"
_STREAMING = "ROADMAP Queue 1 item 9 (texture streaming)"
INDIRECT_MODES = ("none", "sharc", "ssgi", "restir", "ddgi", "combined")


def check_config(cfg: Config):
    """Raise NotImplementedError for any option this port does not run yet."""
    def need(ok, what, slice_):
        if not ok:
            raise NotImplementedError(f"{what} is not ported yet: {slice_}")

    if cfg.mode not in RenderingMode.ALL:
        raise ValueError(f"unknown mode '{cfg.mode}' ({' | '.join(RenderingMode.ALL)})")
    if cfg.mode != RenderingMode.PATH_TRACER:
        # the path tracer reads none of the deferred frame's options
        if (cfg.direct_mode or "simple") not in ("simple", "restir"):
            raise ValueError(f"unknown direct mode '{cfg.direct_mode}' (simple | restir)")
        if (cfg.indirect_mode or "none") not in INDIRECT_MODES:
            raise ValueError(f"unknown indirect mode '{cfg.indirect_mode}' "
                             f"({' | '.join(INDIRECT_MODES)})")
        if (cfg.direct_mode or "simple") == "restir" and cfg.denoiser not in ("relax", "reblur"):
            raise ValueError(f"unknown denoiser '{cfg.denoiser}' (relax | reblur)")
        need(cfg.render_scale == 1.0, "--render-scale != 1 (TAA upscaling)", _OPTIONS)
    need(not cfg.tex_streaming, "texture streaming", _STREAMING)
    need(not (cfg.envmap or cfg.irradiance or cfg.radiance or cfg.brdflut
              or cfg.env_lights), "environment maps / authored IBL", _ENV)
    need(not (cfg.debug_view or cfg.csm_debug or cfg.ddgi_debug or cfg.tex_debug),
         "debug views", _DEBUG)
    need(not cfg.execute_per_pass, "--execute-per-pass", _OPTIONS)
    need(not cfg.tune_file, "--tune-file", _OPTIONS)
    need(not cfg.keep_hdr, ".hdr screenshots", _ENV)


def device_view_constants(vc, device) -> dict:
    """A camera's view constants (numpy, Camera.view_constants) on
    ``device``: matrices as f32 tensors, scalars as python numbers, plus the
    frustum planes."""
    out = {}
    for k, v in vc.items():
        a = np.asarray(v)
        if a.ndim == 0:
            out[k] = int(a) if a.dtype.kind in "iu" else float(a)
        elif k == "viewport":
            out[k] = (float(a[0]), float(a[1]))
        else:
            out[k] = torch.as_tensor(a.astype(np.float32), device=device)
    out["frustum_planes"] = torch.as_tensor(
        hm.extract_frustum_planes(np.asarray(vc["view_proj"], np.float32)),
        dtype=torch.float32, device=device)
    return out


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() "
                           "is False")
    return dev


class Renderer:
    def __init__(self, config: Optional[Config] = None, device="cuda"):
        self.config = config or Config()
        cfg = self.config
        check_config(cfg)
        self.device = resolve_device(device)
        # fp32 everywhere: the raster transform's einsums must not drop to TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with PROFILER.scope("Init/SceneLoad"):
            if cfg.scene in (None, "", "cube"):
                self.scene = make_default_cube_scene()
            elif cfg.scene == "stress":
                self.scene = make_stress_scene()
            elif cfg.scene.startswith("stress:"):
                self.scene = make_stress_scene(grid=int(cfg.scene.split(":")[1]))
            else:
                from hobbyrenderer_tpu_torch.scene.loader import load_gltf_scene
                self.scene = load_gltf_scene(cfg.scene, cache_dir=cfg.cache_dir)
        if self.scene.animations:
            raise NotImplementedError(
                f"animated scenes need a per-frame BVH refit, not ported yet: {_ANIM}")
        if getattr(self.scene, "env_map_path", ""):
            raise NotImplementedError(f"scene environment maps are not ported yet: {_ENV}")
        with PROFILER.scope("Init/Upload"):
            self.gpu = build_scene_gpu(self.scene, self.device,
                                       max_lights=max(64, len(self.scene.lights) + 8))
        cam_desc = self.scene.cameras[0] if self.scene.cameras else None
        self.camera = Camera(cam_desc, cfg.render_width, cfg.render_height)
        if cam_desc is None or np.allclose(self.camera.position, [0, 1, 5]):
            self.camera.position = (self.scene.center
                                    + np.asarray([0.6, 0.45, 1.1], np.float32)
                                    * self.scene.radius * 1.6)
            self.camera.look_at(self.scene.center)
        self.frame_index = 0
        self.last_frame = None
        self.time_s = 0.0
        self._scene_key = cfg.scene or "default"
        self.camera_state = CameraStateManager(
            path=os.path.join(cfg.cache_dir, "camera_state.json"))
        os.makedirs(cfg.cache_dir, exist_ok=True)
        self.camera_state.restore(self.camera, self._scene_key)
        self.camera_state.start()
        self.bvh_seconds = 0.0
        self.mode = cfg.mode
        self._build_model()

    def _build_rt(self, with_pool: bool):
        """The ray-tracing scene; with the light pool and the 16-wide BVH
        when ``with_pool``."""
        with PROFILER.scope("Init/BVH"):
            t0 = time.perf_counter()
            rt = build_scene_rt(self.scene, self.device, gpu=self.gpu if with_pool else None)
            self.bvh_seconds = time.perf_counter() - t0
        return rt

    def _build_model(self):
        cfg = self.config
        if self.mode == RenderingMode.PATH_TRACER:
            if cfg.render_scale != 1.0:
                print("warning: --render-scale is a TAA-upscaling feature of the deferred "
                      "modes; the reference path tracer renders at the internal resolution "
                      f"{cfg.render_width}x{cfg.render_height}")
            self._model = PathTracerRenderer(self.gpu, cfg.render_width, cfg.render_height,
                                             config=cfg, rt=self._build_rt(True))
            return
        direct = cfg.direct_mode or "simple"
        indirect = cfg.indirect_mode or "none"
        # the JAX Renderer's rule: the RT scene in the Normal and IBL modes
        # and for DDGI or ReSTIR GI; the light pool and the 16-wide BVH only
        # where a pass walks them (RTXDI, RTXDIGI, SHARC, DDGI, SpecularIndirect)
        rt = None
        traced_mode = self.mode in (RenderingMode.NORMAL, RenderingMode.IBL)
        if traced_mode or indirect in ("ddgi", "restir"):
            g = pass_gates(self.mode, direct, indirect, cfg.specular_indirect, True)
            rt = self._build_rt(any(g[k] for k in ("use_restir", "use_restir_gi", "use_sharc",
                                                   "use_ddgi", "use_spec")))
        self._model = DeferredRenderer(self.gpu, cfg.render_width, cfg.render_height,
                                       rt=rt, shadow_scale=cfg.shadow_scale, mode=self.mode,
                                       direct_mode=direct, indirect_mode=indirect,
                                       restir_quality=cfg.restir_quality,
                                       denoiser_profile=cfg.denoiser,
                                       specular_indirect=cfg.specular_indirect,
                                       regir=cfg.regir, regir_mode=cfg.regir_mode)

    def set_mode(self, mode: str):
        """Switch the rendering mode: rebuild the model (and its ray-tracing
        scene), dropping the old mode's persistent state."""
        if mode != self.mode:
            check_config(dataclasses.replace(self.config, mode=mode))
            self.mode = mode
            self._build_model()

    @property
    def graph(self):
        """The frame's pass graph (None for the path tracer, which has none)."""
        return self._model.graph

    def view_constants(self) -> dict:
        """Camera constants for this frame: matrices as device tensors,
        scalars as python numbers, plus the frustum planes."""
        return device_view_constants(self.camera.view_constants(self.frame_index), self.device)

    def render_frame(self, dt: float = 1.0 / 60.0):
        cfg = self.config
        with PROFILER.scope("Frame/SceneUpdate"):
            self.time_s += dt
            self.scene.update(self.time_s)
            # a scene without animations is only dirty from its load: the
            # uploaded tables and the BVH already hold those transforms
            self.gpu = update_instance_transforms(self.gpu, self.scene)
            self.scene.dirty_materials.clear()
        with PROFILER.scope("Frame/ViewConstants"):
            vc = self.view_constants()
        with PROFILER.scope("Frame/Render"):
            # the host matrix: the path tracer's camera-move reset compares it
            view_proj = self.camera.view_constants(self.frame_index)["view_proj_no_jitter"]
            ldr = self._model.render(self.gpu, vc, cfg.settings, dt, view_proj)
        self.camera.end_frame()
        self.camera_state.publish(self.camera, self._scene_key)
        self.frame_index += 1
        self.last_frame = ldr
        PROFILER.end_frame()
        return ldr

    def synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, num_frames: int = 1, screenshot: Optional[str] = None,
            dt: float = 1.0 / 60.0):
        t0 = time.perf_counter()
        for _ in range(num_frames):
            self.render_frame(dt)
        self.synchronize()
        wall = time.perf_counter() - t0
        if screenshot:
            self.save_screenshot(screenshot)
        return {"frames": num_frames, "wall_s": wall,
                "ms_per_frame": wall / max(num_frames, 1) * 1e3,
                "device": str(self.device)}

    def save_screenshot(self, path: str):
        assert self.last_frame is not None, "render a frame first"
        write_png(path, self.last_frame.cpu().numpy())

    def shutdown(self):
        self.camera_state.stop(flush=True)

    def stats(self) -> dict:
        return {k: (v.item() if isinstance(v, torch.Tensor) else v)
                for k, v in self._model.last_stats.items()}

    def describe_graph(self) -> str:
        return self.graph.describe() if self.graph is not None else "(no graph)"

    def timings(self) -> str:
        return PROFILER.table()
