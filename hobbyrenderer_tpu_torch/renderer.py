"""Top-level Renderer: scene, camera, frame graph and frame loop on an
explicit torch device (counterpart of hobbyrenderer_tpu/renderer.py).

Ported: the deferred frame in the Normal, IBL and NormalBasic modes with
simple direct lighting or ReSTIR DI (``direct_mode="restir"``, every
``restir_quality`` preset, both denoisers, with or without ``regir`` in
either ``regir_mode``) and every ``indirect_mode`` (none, sharc, ssgi,
restir, ddgi, combined; traced specular unless ``specular_indirect`` is
off), each pass run where the JAX package runs it (restir + restir in
Normal mode is the flagship frame), TAA upscaling (``render_scale``),
and the reference path tracer (``mode="path_tracer"``, progressive,
``pt_spp`` samples a frame); environment maps (``envmap``, the prebaked
``irradiance`` / ``radiance`` maps, ``brdflut``, ``env_lights``), animated
scenes (refitted on the device each frame an instance moved), the per-pass
execution (``execute_per_pass``), live tuning (``tune_file``), .hdr
screenshots, texture streaming (``tex_streaming``: a TextureStreamer's
worker thread schedules tile uploads within ``tex_budget_mb``, the frame
loop applies them and fetches the demand feedback every 8th frame) and the
debug views and overlays (``debug_view``, ``csm_debug``, ``ddgi_debug``,
``tex_debug``). Multi-GPU rendering is ``hobbyrenderer_tpu_torch.parallel``
(row bands and the sample-parallel path tracer on torch.distributed), which
renders the scene, camera and settings a Renderer loads
(``bench_parallel.py``)."""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from hobbyrenderer_tpu_torch.config import Config, RenderingMode
from hobbyrenderer_tpu_torch.scene.camera import Camera
from hobbyrenderer_tpu_torch.scene.procedural import make_default_cube_scene, make_stress_scene
from hobbyrenderer_tpu_torch.scene.camera_state import CameraStateManager
from hobbyrenderer_tpu_torch.scene.scene import LIGHT_DIRECTIONAL, Light
from hobbyrenderer_tpu_torch.utils import math as hm
from hobbyrenderer_tpu_torch.utils.image import write_png
from hobbyrenderer_tpu_torch.utils.timing import PROFILER
from hobbyrenderer_tpu_torch.models.deferred import DeferredRenderer, pass_gates
from hobbyrenderer_tpu_torch.models.pathtracer import PathTracerRenderer
from hobbyrenderer_tpu_torch.models.scene_rt import build_scene_rt, refit_scene_rt
from hobbyrenderer_tpu_torch.ops import envmap as envops
from hobbyrenderer_tpu_torch.ops.lights import refresh_pool_emissive
from hobbyrenderer_tpu_torch.scene.gpu import (build_scene_gpu, update_instance_transforms,
                                               update_material_constants)

INDIRECT_MODES = ("none", "sharc", "ssgi", "restir", "ddgi", "combined")


def check_config(cfg: Config):
    """Raise ValueError for an unknown mode, direct or indirect mode, or
    denoiser (the debug view's name is checked with the graph, as in the
    JAX package)."""
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


def device_view_constants(vc, device) -> dict:
    """A camera's view constants (numpy, Camera.view_constants) on
    ``device``: matrices as f32 tensors, scalars, the viewport and the
    jitter as python numbers, plus the frustum planes."""
    out = {}
    for k, v in vc.items():
        a = np.asarray(v)
        if a.ndim == 0:
            out[k] = int(a) if a.dtype.kind in "iu" else float(a)
        elif k in ("viewport", "jitter"):
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
    def __init__(self, config: Optional[Config] = None, scene=None, device="cuda"):
        """``scene``: a finalized Scene to render instead of ``config.scene``
        (which then only keys the saved camera). The environment's
        directional lights (``env_lights``) are added to it."""
        self.config = config or Config()
        cfg = self.config
        check_config(cfg)
        self.device = resolve_device(device)
        # fp32 everywhere: the raster transform's einsums must not drop to TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with PROFILER.span("Init/SceneLoad"):
            if scene is not None:
                self.scene = scene
            elif cfg.scene in (None, "", "cube"):
                self.scene = make_default_cube_scene()
            elif cfg.scene == "stress":
                self.scene = make_stress_scene()
            elif cfg.scene.startswith("stress:"):
                self.scene = make_stress_scene(grid=int(cfg.scene.split(":")[1]))
            else:
                from hobbyrenderer_tpu_torch.scene.loader import load_gltf_scene
                self.scene = load_gltf_scene(cfg.scene, cache_dir=cfg.cache_dir)
        self.streamer = None
        if cfg.tex_streaming:
            # the pool holds tex_budget_mb of 16-byte texels (at least 16 pages)
            from hobbyrenderer_tpu_torch.scene.streaming import PAGE_TEXELS, TextureStreamer
            pages = max((cfg.tex_budget_mb * (1 << 20)) // (PAGE_TEXELS * 16), 16)
            self.streamer = TextureStreamer(self.scene, budget_pages=pages)
        # device-to-host copies of the streaming feedback (one every 8th frame)
        self.feedback_syncs = 0
        env, env_sh, brdf_lut = self._load_environment()
        with PROFILER.span("Init/Upload"):
            self.gpu = build_scene_gpu(self.scene, self.device,
                                       max_lights=max(64, len(self.scene.lights) + 8),
                                       env_map=env, env_sh=env_sh, brdf_lut=brdf_lut,
                                       streamer=self.streamer)
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
        self._tune_mtime = 0.0
        self._tune_warned: set = set()
        self.bvh_seconds = 0.0
        # power-CDF refreshes of the light pool, each a copy to the host and back
        self.pool_cdf_syncs = 0
        self.mode = cfg.mode
        self._build_model()

    def _load_environment(self):
        """The environment map (``envmap``, else the scene's own), its
        prebaked irradiance SH (``irradiance``, or the envmap's
        ``<stem>_irradiance`` sibling) and radiance (``radiance`` /
        ``<stem>_radiance``), and the authored BRDF LUT (``brdflut``) ->
        (env (H, W, 3) | None, env_sh (9, 3) | None, lut (N, N, 2) | None).
        With ``env_lights`` > 0 under ReSTIR DI or the path tracer, the map
        also becomes that many directional lights of the scene."""
        cfg = self.config
        env_path = cfg.envmap or getattr(self.scene, "env_map_path", "")
        env = envops.load_envmap(env_path) if env_path else None
        irr_path, rad_path = cfg.irradiance, cfg.radiance
        if env_path and not (irr_path or rad_path):
            stem, _ext = os.path.splitext(env_path)
            for ext in (".hdr", ".dds"):
                if not irr_path and os.path.exists(stem + "_irradiance" + ext):
                    irr_path = stem + "_irradiance" + ext
                if not rad_path and os.path.exists(stem + "_radiance" + ext):
                    rad_path = stem + "_radiance" + ext
        # an irradiance map stores E / pi: projected without the cosine lobe
        env_sh = (envops.project_sh9(np.asarray(envops.load_envmap(irr_path), np.float32),
                                     convolved=True) if irr_path else None)
        if rad_path and env is None:
            env = envops.load_envmap(rad_path)
        brdf_lut = None
        if cfg.brdflut:
            from hobbyrenderer_tpu_torch.scene.textures import load_image_file
            brdf_lut = load_image_file(cfg.brdflut)[..., :2].astype(np.float32) / 255.0
        n_lights = int(cfg.env_lights or 0)
        # the pool machinery (ReSTIR DI) or the path tracer's NEE consumes
        # them; the simple direct mode keeps the IBL ambient
        self._env_as_lights = (env is not None and n_lights > 0
                               and (cfg.direct_mode == "restir"
                                    or cfg.mode == RenderingMode.PATH_TRACER))
        if self._env_as_lights:
            dirs, colors = envops.env_to_directional_lights(env, n_lights)
            for k in range(dirs.shape[0]):
                self.scene.add_light(Light(type=LIGHT_DIRECTIONAL, direction=-dirs[k],
                                           color=colors[k], intensity=1.0,
                                           name=f"envlight{k}"))
        return env, env_sh, brdf_lut

    def _build_rt(self, with_pool: bool):
        """The ray-tracing scene; with the light pool and the 16-wide BVH
        when ``with_pool``."""
        with PROFILER.span("Init/BVH"):
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
                                             config=cfg, rt=self._build_rt(True),
                                             env_as_lights=self._env_as_lights)
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
                                       regir=cfg.regir, regir_mode=cfg.regir_mode,
                                       env_as_lights=self._env_as_lights,
                                       out_width=cfg.width, out_height=cfg.height,
                                       execute_per_pass=cfg.execute_per_pass,
                                       tex_debug=cfg.tex_debug, csm_debug=cfg.csm_debug,
                                       ddgi_debug=cfg.ddgi_debug, debug_view=cfg.debug_view)
        if cfg.keep_hdr:                # the linear frame, for .hdr screenshots
            self._model.keep = ("hdr",)

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

    def _poll_tune_file(self):
        """Live tuning: when ``tune_file`` is set, re-read it whenever its
        mtime advances and map its keys onto RenderSettings; a changed knob
        applies from the next frame. Unknown keys and the static ones
        (read once when the model is built) are reported once and
        ignored."""
        path = self.config.tune_file
        if not path or not os.path.exists(path):
            return
        try:
            mtime = os.path.getmtime(path)
            if mtime <= self._tune_mtime:
                return
            with open(path) as f:
                knobs = json.load(f)
            self._tune_mtime = mtime
        except (OSError, ValueError):
            return      # a partial write; read again next frame
        s = self.config.settings
        names = {f.name for f in dataclasses.fields(s) if not f.name.startswith("_")}
        updates = {}
        for k, v in knobs.items():
            if k not in names or k in s._static_fields:
                if k not in self._tune_warned:
                    self._tune_warned.add(k)
                    kind = "static (needs restart)" if k in s._static_fields else "unknown"
                    print(f"[tune] ignoring {kind} knob '{k}'")
                continue
            cur = getattr(s, k)
            try:
                updates[k] = tuple(v) if isinstance(cur, (tuple, list)) else type(cur)(v)
            except (TypeError, ValueError):
                if k not in self._tune_warned:
                    self._tune_warned.add(k)
                    print(f"[tune] ignoring knob '{k}': bad value {v!r}")
        if updates:
            self.config = dataclasses.replace(self.config,
                                              settings=dataclasses.replace(s, **updates))

    def render_frame(self, dt: float = 1.0 / 60.0):
        with PROFILER.frame():
            self._poll_tune_file()
            cfg = self.config
            with PROFILER.span("Frame/SceneUpdate"):
                self.time_s += dt
                self.scene.update(self.time_s)
                # as the JAX Renderer: every instance and material is dirty from
                # the load, so the first frame refits and refreshes too
                dirty_rt = bool(self.scene.dirty_instances)
                dirty_mat = bool(self.scene.dirty_materials)
                self.gpu = update_instance_transforms(self.gpu, self.scene)
                if dirty_mat:
                    self.gpu = update_material_constants(self.gpu, self.scene)
                rt = self._model.rt
                if dirty_mat and rt is not None and rt.lights is not None:
                    # animated emissive strength drives the light the emitter casts
                    self._model.rt = rt._replace(lights=refresh_pool_emissive(
                        rt.lights, self.gpu, rt.tri_mat))
                    self.pool_cdf_syncs += 1
            if dirty_rt and self._model.rt is not None:
                with PROFILER.span("Frame/RTRefit"):
                    self._model.rt = refit_scene_rt(self._model.rt, self.gpu.inst_transform)
            if self.streamer is not None:
                # a finished tile-upload batch, applied at frame start
                with PROFILER.span("Frame/TexStreaming"):
                    self.gpu = dataclasses.replace(
                        self.gpu, tex_stream=self.streamer.apply_updates(self.gpu.tex_stream),
                        meta=self.gpu.meta)
            with PROFILER.span("Frame/ViewConstants"):
                vc = self.view_constants()
            with PROFILER.span("Frame/Render"):
                # the host matrix: the path tracer's camera-move reset compares it
                view_proj = self.camera.view_constants(self.frame_index)["view_proj_no_jitter"]
                ldr = self._model.render(self.gpu, vc, cfg.settings, dt, view_proj)
            if self.streamer is not None and self.frame_index % 8 == 7:
                # the feedback fetch, on this thread (the worker never touches a
                # device tensor): one device-to-host copy every 8th frame
                fb = self._model.last_stats.get("tex_feedback")
                if fb is not None:
                    with PROFILER.span("Frame/TexFeedback"):
                        self.streamer.publish_feedback(fb.cpu().numpy())
                    self.feedback_syncs += 1
            self.camera.end_frame()
            self.camera_state.publish(self.camera, self._scene_key)
            self.frame_index += 1
            self.last_frame = ldr
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
        """A PNG of the last frame; a .hdr path writes the linear frame
        before the tonemap as Radiance RGBE (the deferred frame's needs
        ``keep_hdr``; the path tracer's is its accumulation)."""
        if self.last_frame is None:
            raise RuntimeError("render a frame first")
        if path.lower().endswith(".hdr"):
            if self.mode == RenderingMode.PATH_TRACER:
                hdr = self._model.accum
            else:
                hdr = self._model.last_resources.get("hdr")
            if hdr is None:
                raise ValueError(".hdr screenshots need Config(keep_hdr=True) (the CLI sets "
                                 "it for --screenshot *.hdr)")
            with open(path, "wb") as f:
                f.write(envops.encode_hdr(hdr.cpu().numpy()))
            return
        write_png(path, self.last_frame.cpu().numpy())

    def shutdown(self):
        """Flush the camera state and stop the streamer's worker."""
        self.camera_state.stop(flush=True)
        if self.streamer is not None:
            self.streamer.stop()

    def stats(self) -> dict:
        out = {k: (v.item() if isinstance(v, torch.Tensor) else v)
               for k, v in self._model.last_stats.items() if k != "tex_feedback"}
        out["pool_cdf_host_syncs"] = self.pool_cdf_syncs
        if self.streamer is not None:
            st = self.streamer
            out["tex_feedback_host_syncs"] = self.feedback_syncs
            out["stream_free_pages"] = len(st.free_pages)
            out["stream_budget_pages"] = st.budget_pages
            out["stream_resident_mips"] = st.resident.tolist()
            out["stream_tiles_uploaded"] = st.tiles_uploaded
        return out

    def describe_graph(self) -> str:
        return self.graph.describe() if self.graph is not None else "(no graph)"

    def export_graph(self) -> dict:
        """The pass graph as JSON-ready data (RenderGraph.export_json), {}
        for the path tracer."""
        return self.graph.export_json() if self.graph is not None else {}

    def timings(self) -> str:
        out = PROFILER.table()
        g = self.graph
        if g is not None and g.last_pass_timings:
            rows = "\n".join(f"  {t['pass']:20s} {t['ms']:9.2f} ms" for t in g.last_pass_timings)
            out += "\nPer-pass time (--execute-per-pass):\n" + rows
        return out
