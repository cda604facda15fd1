"""Global configuration + CLI parsing.

Reference: src/Config.h:5-31, src/Config.cpp:4-136 — a flag singleton parsed from the
command line (--scene, --rhidebug, --execute-per-pass, env-map overrides).

TPU design: a plain dataclass tree. Startup options (scene path, resolution, rendering
mode) are static — changing them re-jits. Live-tunable options (the reference's ~80
public Renderer members bound to ImGui, src/Renderer.h:285-418) live in
``RenderSettings`` and flow into the jitted frame function as a pytree of scalars, so
tweaking them does NOT retrigger compilation.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import Optional


class RenderingMode:
    """Reference: enum in src/Common.sr / src/Renderer.cpp:1278-1323."""

    NORMAL = "normal"                  # deferred + RT: ReSTIR DI/GI, SHARC, denoise
    NORMAL_BASIC = "normal_basic"      # raster-only: CSM, screen-space shadows, SSGI/DDGI
    IBL = "ibl"                        # image-based-lighting-dominant deferred
    PATH_TRACER = "path_tracer"        # unbiased progressive reference path tracer

    ALL = (NORMAL, NORMAL_BASIC, IBL, PATH_TRACER)


class IndirectLightingMode:
    """Reference: Renderer::m_IndirectLightingMode select in DeferredRenderer."""

    NONE = 0
    RESTIR_GI = 1
    SHARC = 2
    SSGI = 3
    DDGI = 4


@dataclass
class RenderSettings:
    """Live-tunable per-frame settings (jit-stable: only array/scalar leaves).

    These mirror the reference's runtime toggles (src/Renderer.h:285-418) that do not
    change array shapes. They are passed into the frame function every frame.
    """

    sun_direction: tuple = (0.3, -0.8, 0.5)     # normalized at use
    sun_intensity: float = 10.0                 # radiometric scale
    sun_angular_radius: float = 0.004675        # radians (~0.268 deg, solar disk)
    sun_color: tuple = (1.0, 1.0, 1.0)
    exposure_compensation: float = 0.0          # EV
    min_log_luminance: float = -10.0            # histogram range, ref HDRRenderer.cpp:12
    max_log_luminance: float = 20.0
    adaptation_speed: float = 1.5
    bloom_intensity: float = 0.04
    bloom_radius: float = 0.85
    bloom_knee: float = 0.5
    bloom_threshold: float = 1.0
    taa_blend: float = 0.1                      # history feedback min
    shadow_bias: float = 0.05                   # world-space shadow ray offset
    #   (covers raster-LOD vs LOD0-BVH surface mismatch; ref normal-bias in
    #    ShadowMask.hlsl per-cascade anisotropic bias)
    sharpness: float = 0.0
    ambient_scale: float = 1.0
    max_bounces: int = 8                        # ref src/Renderer.h:299 (STATIC: loop bound)
    rr_start_bounce: int = 2                    # ref PathTracer.hlsl:263-270
    ibl_intensity: float = 1.0

    # Fields that are jit-STATIC (control flow / shapes) and stay out of the pytree
    _static_fields = ("max_bounces",)

    def as_pytree(self):
        """Per-frame uniforms (floats/vecs only) as a plain dict of numpy
        values — the volatile constant-buffer analogue."""
        import numpy as _np
        out = {}
        for f in dataclasses.fields(self):
            if f.name.startswith("_") or f.name in self._static_fields:
                continue
            v = getattr(self, f.name)
            if isinstance(v, (tuple, list)):
                out[f.name] = _np.asarray(v, _np.float32)
            elif isinstance(v, (int, float)):
                out[f.name] = _np.float32(v)
        return out


@dataclass
class Config:
    """Startup configuration (static: changing these re-compiles).

    Mirrors the reference CLI (src/Config.cpp:4-136).
    """

    scene: Optional[str] = None           # --scene path (glTF / .scene.json); None = default cube
    width: int = 1920
    height: int = 1080
    render_scale: float = 1.0
    mode: str = RenderingMode.NORMAL
    envmap: Optional[str] = None          # --envmap / --irradiance / --radiance / --brdflut
    debug: bool = False                   # --rhidebug analogue: enable jit checks / NaN checks
    debug_gpu: bool = False               # --rhidebug-gpu analogue: pallas interpret mode
    execute_per_pass: bool = False        # serialise pass execution (block_until_ready per pass)
    disable_aliasing: bool = False        # disable buffer donation (debugging)
    cache_dir: str = ".hr_cache"          # cooked mesh cache directory
    seed: int = 0
    shadow_scale: int = 2                 # RT sun-shadow resolution divisor (STATIC)
    direct_mode: str = "simple"           # "simple" analytic | "restir" (ReSTIR DI)
    indirect_mode: str = "none"           # "none"|"sharc"|"ssgi"|"restir"|"ddgi"
    ddgi_debug: bool = False              # probe visualization overlay
    csm_debug: bool = False               # cascade debug view (ref CSMDebugRenderer)
    tex_debug: bool = False               # streaming residency heatmap
    #                                       (ref TileResidencyDebugRenderer)
    regir: bool = False                   # ReGIR world-space light grid (ref RTXDI)
    regir_mode: str = "onion"             # "onion" (ref default: camera-centered
    #                                       detail+coverage shells) | "grid"
    irradiance: str = None                # prebaked irradiance map (equirect
    #                                       HDR/DDS; ref --irradiance cubemap)
    radiance: str = None                  # prebaked prefiltered radiance env
    #                                       (ref --radiance cubemap)
    brdflut: str = None                   # authored split-sum BRDF LUT image
    #                                       (ref --brdflut)
    restir_quality: str = "balanced"      # "highperf" | "balanced" |
    #                                       "highquality" (ref RTXDI quality
    #                                       presets, RTXDIRenderer.cpp:96-247)
    specular_indirect: bool = True        # traced glossy/mirror reflections
    #                                       (ref BrdfRayTracing; needs an RT
    #                                       indirect mode to activate)
    denoiser: str = "relax"               # "relax" | "reblur" (ref NRD pipelines)
    keep_hdr: bool = False                # expose the linear HDR frame (for .hdr screenshots)
    env_lights: int = 0                   # envmap -> N pool directionals (ref env PDF presampling)
    tex_streaming: bool = False           # budgeted texture residency (scene/streaming.py)
    pt_spp: int = 1                       # path-tracer samples/frame, batched
    #                                       into ONE wavefront (--pt-spp)
    tex_budget_mb: int = 64               # streamed texel pool budget
    tune_file: Optional[str] = None       # live-tuning knob JSON re-read per
    #                                       frame onto RenderSettings (the
    #                                       ImGui panel analogue: the traced
    #                                       pytree means changes apply next
    #                                       frame with NO recompile;
    #                                       ref src/Renderer.h:285-418)
    debug_view: Optional[str] = None      # named debug visualization
    #                                       (ref CSMDebug.hlsl modes /
    #                                       SSGIDebug outputs); see
    #                                       ops/debugview.py for names
    # Parallelism: framebuffer tile-sharding across the device mesh (SURVEY.md §5.8)
    num_devices: int = 0                  # 0 = all available
    settings: RenderSettings = field(default_factory=RenderSettings)

    @property
    def render_width(self) -> int:
        return int(self.width * self.render_scale)

    @property
    def render_height(self) -> int:
        return int(self.height * self.render_scale)

    @staticmethod
    def parse_command_line(argv=None) -> "Config":
        """Reference: Config::ParseCommandLine (src/Config.cpp:4-136)."""
        p = argparse.ArgumentParser(prog="hobbyrenderer-tpu")
        p.add_argument("--scene", type=str, default=None)
        p.add_argument("--width", type=int, default=1920)
        p.add_argument("--height", type=int, default=1080)
        p.add_argument("--mode", type=str, default=RenderingMode.NORMAL,
                       choices=RenderingMode.ALL)
        p.add_argument("--envmap", type=str, default=None)
        p.add_argument("--rhidebug", dest="debug", action="store_true")
        p.add_argument("--rhidebug-gpu", dest="debug_gpu", action="store_true")
        p.add_argument("--execute-per-pass", dest="execute_per_pass", action="store_true")
        p.add_argument("--disable-rendergraph-aliasing", dest="disable_aliasing",
                       action="store_true")
        p.add_argument("--cache-dir", type=str, default=".hr_cache")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--num-devices", type=int, default=0)
        a = p.parse_args(argv)
        return Config(scene=a.scene, width=a.width, height=a.height, mode=a.mode,
                      envmap=a.envmap, debug=a.debug, debug_gpu=a.debug_gpu,
                      execute_per_pass=a.execute_per_pass,
                      disable_aliasing=a.disable_aliasing, cache_dir=a.cache_dir,
                      seed=a.seed, num_devices=a.num_devices)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
