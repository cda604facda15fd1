"""Deferred rendering, the Normal, IBL and NormalBasic modes (counterpart
of hobbyrenderer_tpu/models/deferred.py). Normal mode with simple direct
lighting (the default) runs 15 passes on the stress scene:

Culling -> Raster -> HZBBuild -> RasterPhase2 -> ResolveGBuffer ->
MaskedLayer -> SunShadow -> IBL -> DeferredLighting -> Sky -> Transparent ->
TAA -> AutoExposure -> Bloom -> Tonemap.

With ``direct_mode="restir"`` SunShadow is off and RTXDI + Denoise run after
IBL (16 passes): ReSTIR DI (ops/restir.py) feeds DeferredLighting's direct
term through the RELAX/REBLUR denoiser (ops/denoise.py). With
``indirect_mode="restir"`` RTXDIGI (ReSTIR GI, ops/restir_gi.py) runs after
RTXDI and SpecularIndirect (traced reflections, ops/specular.py, unless
``specular_indirect`` is off) before DeferredLighting; both restir modes
together are the flagship frame's 18 passes:

Culling -> Raster -> HZBBuild -> RasterPhase2 -> ResolveGBuffer ->
MaskedLayer -> IBL -> RTXDI -> RTXDIGI -> Denoise -> SpecularIndirect ->
DeferredLighting -> Sky -> Transparent -> TAA -> AutoExposure -> Bloom ->
Tonemap.

``indirect_mode`` "sharc" adds SHARC (the world-space radiance cache,
ops/sharc.py: a quarter-res bounce updates it, a full-res query reads it),
"combined" adds SharcIndirectQuery after it (a traced half-res bounce whose
hit reads the cache, denoised and upsampled, in place of the full-res
query); "ddgi" and "ssgi" add DDGI (ops/ddgi.py) or SSGI (ops/ssgi.py) in
every mode. SpecularIndirect runs with any of restir, sharc, ddgi and
combined. ``regir`` makes RTXDI draw its candidates from a per-frame ReGIR
cell table (ops/regir.py) instead of the presample tiles.

The IBL mode is the Normal graph with the IBL ambient doubled (in
DeferredLighting and Transparent). With an environment map (SceneGPU.env_map)
the IBL pass reads its load-time SH projection (or a prebaked irradiance
map's), and the Sky pass, the ambient's reflections, SpecularIndirect's
misses and Transparent's refracted misses sample it; with ``env_as_lights``
the environment rides the light list as directional lights instead, and the
ambient and the reflection misses drop it. With an output size above the
render size, TAA upscales (ops/taa.py::taau_resolve) and AutoExposure,
Bloom and Tonemap run at the output size. NormalBasic replaces SunShadow with
ShadowCSM (cascaded shadow maps times screen-space contact shadows,
ops/csm.py and ops/sss.py) and runs none of the ray-traced lighting passes
(RTXDI, RTXDIGI, SHARC, SpecularIndirect). ``pass_gates`` holds these
rules, the JAX package's.

Under texture streaming (``gpu.tex_stream``) every resolve samples through
the residency tables and ResolveGBuffer also writes the frame's demand
histogram ("tex_feedback", fetched by the Renderer for its streamer). The
debug passes run after Tonemap on the uint8 frame, at native resolution
only: DDGIDebug (``ddgi_debug`` with DDGI), CSMDebug (``csm_debug`` in
NormalBasic), TexResidencyDebug (``tex_debug`` under streaming) and, with
``debug_view``, DebugView (one of ops/debugview.py's named views, checked
when the graph is built as the JAX graph checks it).

Raster passes go through the tile-raster kernel K1 (ops/raster_kernel.py),
the shadow atlas through its depth-only sibling K5, SunShadow, the RTXDI
winner rays and the GI sample visibility through the any-hit kernel K4
(ops/beam.py), RTXDI's candidates through the candidate kernel K2
(ops/restir_kernel.py), and its straggler rays, the DDGI probe rays, the
GI and SHARC bounce rays, the reflection rays and every NEE ray through the
bvh16 walk K3
(ops/bvh16.py), as on the JAX package's TPU default. The sorted-block
closest-hit kernel K6 (ops/trace_kernel.py) is the route that
``closest_hit_auto(..., force_kernel=True)`` takes; no pass asks for it."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from hobbyrenderer_tpu_torch.config import RenderingMode
from hobbyrenderer_tpu_torch.scene.cooker import MESHLET_MAX_TRIS
from hobbyrenderer_tpu_torch.scene.gpu import MATI_ALPHA_MODE
from hobbyrenderer_tpu_torch.graph.rendergraph import FrameContext, RenderGraph, render_pass
from hobbyrenderer_tpu_torch.ops import beam as beamops
from hobbyrenderer_tpu_torch.ops import csm as csmops
from hobbyrenderer_tpu_torch.ops import culling as cullops
from hobbyrenderer_tpu_torch.ops import ddgi as ddgiops
from hobbyrenderer_tpu_torch.ops import debugview as dvops
from hobbyrenderer_tpu_torch.ops import denoise as dnops
from hobbyrenderer_tpu_torch.ops import envmap as envops
from hobbyrenderer_tpu_torch.ops import hzb as hzbops
from hobbyrenderer_tpu_torch.ops import ibl as iblops
from hobbyrenderer_tpu_torch.ops import post as postops
from hobbyrenderer_tpu_torch.ops import raster as rasterops
from hobbyrenderer_tpu_torch.ops import regir as regirops
from hobbyrenderer_tpu_torch.ops import restir as restirops
from hobbyrenderer_tpu_torch.ops import restir_gi as giops
from hobbyrenderer_tpu_torch.ops import sampling as smp
from hobbyrenderer_tpu_torch.ops import shading as shadeops
from hobbyrenderer_tpu_torch.ops import sharc as sharcops
from hobbyrenderer_tpu_torch.ops import sharc_indirect as sharcind
from hobbyrenderer_tpu_torch.ops import specular as specops
from hobbyrenderer_tpu_torch.ops import sky as skyops
from hobbyrenderer_tpu_torch.ops import ssgi as ssgiops
from hobbyrenderer_tpu_torch.ops import sss as sssops
from hobbyrenderer_tpu_torch.ops import taa as taaops
from hobbyrenderer_tpu_torch.ops import transparent as transops
from hobbyrenderer_tpu_torch.ops.resize import resize_bilinear
from hobbyrenderer_tpu_torch.ops.restir_presets import get_preset
from hobbyrenderer_tpu_torch.utils.rng import pcg3d, uniform_from_bits

GI_SCALE = 4           # ReSTIR GI grid divisor
GI_TRACE_STEPS = 512   # the bounce rays' 4-ary step budget (K3: 128 steps)
# the GI and specular counters of Renderer.stats(), per frame (device scalars)
GI_STATS = ("rt_overflow_gi", "rt_k3_lanes_gi", "rt_k3_capped_gi", "rt_k3_lanes_gi_nee",
            "rt_k3_capped_gi_nee")
SPEC_STATS = ("rt_k3_lanes_spec", "rt_k3_capped_spec", "rt_k3_lanes_spec_nee",
              "rt_k3_capped_spec_nee", "spec_past_cap")
# the SHARC update's and the combined mode's traced query's K3 walks
SHARC_STATS = ("rt_k3_lanes_sharc", "rt_k3_capped_sharc", "rt_k3_lanes_sharc_nee",
               "rt_k3_capped_sharc_nee")
SHARCQ_STATS = ("rt_k3_lanes_sharcq", "rt_k3_capped_sharcq", "rt_k3_lanes_sharcq_nee",
                "rt_k3_capped_sharcq_nee")


def _scene_sun_dir(ctx):
    """First directional light's direction (the sun), else the settings'."""
    m = ctx.gpu.meta
    if m["has_sun"]:
        return ctx.gpu.light_dir[m["sun_index"]]
    return torch.tensor(ctx.settings.sun_direction, dtype=torch.float32,
                        device=ctx.gpu.device)


def pass_gates(mode: str, direct_mode: str, indirect_mode: str, specular_indirect: bool,
               with_rt_shadows: bool) -> Dict[str, bool]:
    """Which of the optional passes run (the JAX package's rules,
    models/deferred.py:317-321, 416-417, 470-472, 612, 654, 695-699).
    ``with_rt_shadows``: the frame has a ray-tracing scene."""
    traced = mode in (RenderingMode.NORMAL, RenderingMode.IBL)
    use_restir = direct_mode == "restir" and traced
    use_sharc = indirect_mode in ("sharc", "combined") and traced
    return dict(
        use_restir=use_restir,
        use_sun_shadow=with_rt_shadows and traced and not use_restir,
        use_restir_gi=indirect_mode == "restir" and traced,
        use_sharc=use_sharc,
        use_sharc_traced=use_sharc and indirect_mode == "combined",
        use_ddgi=indirect_mode == "ddgi",
        use_ssgi=indirect_mode == "ssgi",
        use_spec=(specular_indirect and with_rt_shadows and traced
                  and indirect_mode in ("restir", "sharc", "ddgi", "combined")))


def build_deferred_graph(width: int, height: int, visible_capacity: int,
                         mode: str = RenderingMode.NORMAL,
                         has_masked: bool = True, has_transparent: bool = True,
                         masked_capacity: int = None,
                         transparent_capacity: int = None, *,
                         shadow_capacity: int, scene_radius: float,
                         shadow_scale: int = 2, direct_mode: str = "simple",
                         indirect_mode: str = "none",
                         restir_quality: str = "balanced",
                         denoiser_profile: str = "relax",
                         specular_indirect: bool = False, with_rt_shadows: bool = True,
                         regir: bool = False, regir_mode: str = "onion",
                         scene_bounds=None, env_as_lights: bool = False,
                         out_width: int = None, out_height: int = None,
                         streaming: bool = False, tex_debug: bool = False,
                         csm_debug: bool = False, ddgi_debug: bool = False,
                         debug_view: str = None) -> RenderGraph:
    g = RenderGraph()
    gates = pass_gates(mode, direct_mode, indirect_mode, specular_indirect, with_rt_shadows)
    use_restir, use_restir_gi = gates["use_restir"], gates["use_restir_gi"]
    use_sharc, use_sharc_traced = gates["use_sharc"], gates["use_sharc_traced"]
    use_spec, use_ddgi, use_ssgi = gates["use_spec"], gates["use_ddgi"], gates["use_ssgi"]
    # IBL mode: the IBL-dominant ambient (DeferredLighting and Transparent)
    ibl_mult = 2.0 if mode == RenderingMode.IBL else 1.0
    rq = get_preset(restir_quality)
    masked_capacity = max(masked_capacity or visible_capacity, 1)
    transparent_capacity = max(transparent_capacity or visible_capacity, 1)
    # the CSM range follows the scene's bounding sphere
    csm_max_distance = float(min(max(2.0 * scene_radius, 20.0), 400.0))
    h0, w0, hzb_levels = hzbops.hzb_sizes(width, height)
    hzb_eff = hzbops.hzb_effective_size(width, height)
    ow, oh = out_width or width, out_height or height
    upscale = (ow, oh) != (width, height)
    dv_csm = bool(debug_view and debug_view.startswith("csm_"))
    dv_ssgi = bool(debug_view and debug_view.startswith("ssgi_"))
    dv_sharc = bool(debug_view and debug_view.startswith("sharc_"))
    want_tex_debug = tex_debug and streaming

    def env_fn(ctx):
        """The environment map's lookup, or None (the procedural sky)."""
        env = ctx.gpu.env_map
        return None if env is None else (lambda d: envops.sample_equirect(env, d))

    @g.add
    @render_pass("Culling", reads=("hzb",),
                 writes=("visible_slots", "visible_count", "occluded_mask",
                         "occluded_count", "phase2_count",
                         "cull_center", "cull_radius"))
    def _culling(ctx: FrameContext, res):
        """Phase 1 of two-phase occlusion culling: frustum/cone survivors
        that pass last frame's HZB raster now; the rest re-test later."""
        cull = cullops.cull_pairs(ctx.gpu, ctx.vc,
                                  alpha_mask=(True, not has_masked, False))
        base = cull["mask"]
        vis_prev = cullops.hzb_test_spheres(
            res["hzb"], hzb_levels, ctx.vc, cull["ml_center_world"],
            cull["ml_radius_world"], eff_hw=hzb_eff)
        p1 = base & vis_prev
        occ = base & ~vis_prev
        slots, count = cullops.compact_mask(p1, visible_capacity)
        res["visible_slots"] = slots
        res["visible_count"] = count
        res["occluded_mask"] = occ
        res["occluded_count"] = occ.sum()
        res["phase2_count"] = torch.zeros((), dtype=torch.int64, device=occ.device)
        res["cull_center"] = cull["ml_center_world"]
        res["cull_radius"] = cull["ml_radius_world"]

    @g.add
    @render_pass("Raster", reads=("visible_slots",),
                 writes=("raster_depth", "raster_visid", "raster_overflow",
                         "raster_attr"))
    def _raster(ctx, res):
        out, attr = rasterops.rasterize(ctx.gpu, ctx.vc, res["visible_slots"],
                                              width, height)
        res["raster_depth"] = out.depth
        res["raster_visid"] = out.visid
        res["raster_overflow"] = out.overflow
        res["raster_attr"] = attr

    @g.add
    @render_pass("HZBBuild", reads=("raster_depth",), writes=("hzb",),
                 persistent=("hzb",))
    def _hzb(ctx, res):
        res["hzb"] = hzbops.build_hzb(res["raster_depth"], hzb_levels, h0, w0)

    @g.add
    @render_pass("RasterPhase2",
                 reads=("hzb", "raster_depth", "raster_visid", "raster_attr",
                        "occluded_mask", "cull_center", "cull_radius",
                        "visible_slots", "phase2_count"),
                 writes=("raster_depth", "raster_visid", "raster_attr",
                         "visible_slots", "phase2_count"))
    def _raster_phase2(ctx, res):
        """Phase 2: re-test last frame's occludees against the fresh pyramid
        and raster the newly visible ones into the visibility buffer."""
        vis2 = cullops.hzb_test_spheres(res["hzb"], hzb_levels, ctx.vc,
                                        res["cull_center"], res["cull_radius"],
                                        eff_hw=hzb_eff)
        mask2 = res["occluded_mask"] & vis2
        phase2_capacity = max(visible_capacity // 8, 256)
        slots2, cnt2 = cullops.compact_mask(mask2, phase2_capacity)
        ro2, attr2 = rasterops.rasterize(ctx.gpu, ctx.vc, slots2, width, height)
        d1 = res["raster_depth"]
        win = ro2.depth > d1
        offset = visible_capacity * MESHLET_MAX_TRIS
        res["raster_depth"] = torch.where(win, ro2.depth, d1)
        res["raster_visid"] = torch.where(win & (ro2.visid >= 0), ro2.visid + offset,
                                          res["raster_visid"])
        res["raster_attr"] = torch.where(win[..., None], attr2, res["raster_attr"])
        res["visible_slots"] = torch.cat([res["visible_slots"], slots2])
        res["phase2_count"] = cnt2

    @g.add
    @render_pass("ResolveGBuffer", reads=("raster_depth", "raster_visid",
                                          "raster_attr"),
                 writes=("gbuffer",) + (("tex_feedback",) if streaming else ())
                 + (("tex_clamp",) if want_tex_debug else ()))
    def _resolve(ctx, res):
        """The G-buffer; under texture streaming also the demand histogram
        for the host streamer (and with ``tex_debug`` the residency clamp)."""
        ro = rasterops.RasterOutput(res["raster_depth"], res["raster_visid"], None)
        out = rasterops.resolve_gbuffer(ctx.gpu, ctx.vc, ro, res["raster_attr"],
                                        want_feedback=streaming, want_tex_debug=want_tex_debug)
        if want_tex_debug:
            res["gbuffer"], res["tex_feedback"], res["tex_clamp"] = out
        elif streaming:
            res["gbuffer"], res["tex_feedback"] = out
        else:
            res["gbuffer"] = out

    @g.add
    @render_pass("MaskedLayer", reads=("gbuffer",), writes=("gbuffer",))
    def _masked_layer(ctx, res):
        """Alpha-tested geometry as a second visibility layer, merged where
        it passes the cutoff and is nearer than the opaque layer."""
        gb = res["gbuffer"]
        cull = cullops.cull_pairs(ctx.gpu, ctx.vc, alpha_mask=(False, True, False))
        slots, _cnt = cullops.compact_mask(cull["mask"], masked_capacity)
        ro, attr = rasterops.rasterize(ctx.gpu, ctx.vc, slots, width, height)
        mgb = rasterops.resolve_gbuffer(ctx.gpu, ctx.vc, ro, attr)
        keep = mgb.valid & (mgb.alpha >= 0.0) & (mgb.depth > gb.depth)

        def merge(m, g_):
            return torch.where(keep[..., None] if m.ndim == 3 else keep, m, g_)

        merged = rasterops.GBuffer(*[merge(m, g_) for m, g_ in zip(mgb, gb)])
        res["gbuffer"] = merged._replace(valid=gb.valid | keep)

    if not has_masked:
        g.get("MaskedLayer").enabled = False

    @g.add
    @render_pass("SunShadow", reads=("gbuffer",),
                 writes=("sun_shadow", "rt_overflow_sun"))
    def _sun_shadow(ctx, res):
        """Ray-traced sun shadow mask: one cone-jittered shadow ray per
        shadow-res pixel through the any-hit kernel, bilinearly upsampled."""
        gb = res["gbuffer"]
        dev = gb.depth.device
        s = shadow_scale
        sh, sw = height // s, width // s
        pos = gb.world_pos[::s, ::s][:sh, :sw].reshape(-1, 3)
        gn = gb.geo_normal[::s, ::s][:sh, :sw].reshape(-1, 3)
        valid_s = gb.valid[::s, ::s][:sh, :sw].reshape(-1)
        to_sun = -_scene_sun_dir(ctx)
        pix = torch.arange(pos.shape[0], dtype=torch.int64, device=dev)
        bits = pcg3d(torch.stack([pix, torch.full_like(pix, ctx.vc["frame_index"]),
                                  torch.full_like(pix, 77)], -1))
        u1 = uniform_from_bits(bits[..., 0])
        u2 = uniform_from_bits(bits[..., 1])
        cos_max = float(np.cos(np.float32(ctx.settings.sun_angular_radius)))
        L = smp.sample_cone(to_sun.expand_as(pos), cos_max, u1, u2)
        facing = (torch.sum(L * gn, -1) > 0) & valid_s
        bias = ctx.settings.shadow_bias
        o = pos + gn * bias + L * bias
        occ, n_ovf = beamops.beam_any_hit(
            ctx.rt.btable, o.reshape(sh, sw, 3), L.reshape(sh, sw, 3),
            torch.where(facing, 1e8, 1e-4).reshape(sh, sw),
            facing.reshape(sh, sw), sh, sw)
        res["rt_overflow_sun"] = n_ovf
        vis = torch.where(facing, 1.0 - occ.reshape(-1).to(torch.float32), 0.0)
        vis = torch.where(valid_s, vis, 1.0).reshape(sh, sw)
        if s > 1:
            vis = resize_bilinear(vis, height, width)
        res["sun_shadow"] = vis

    if not gates["use_sun_shadow"]:
        g.get("SunShadow").enabled = False

    @g.add
    @render_pass("ShadowCSM", reads=("gbuffer",),
                 writes=("sun_shadow",) + (("csm_data",) if csm_debug or dv_csm else ()))
    def _shadow_csm(ctx, res):
        """NormalBasic sun shadows: the 4-cascade depth atlas (one K5 call),
        a half-res PCF mask bilinearly upsampled, times screen-space contact
        shadows. The cascades are kept for the CSM debug views."""
        gb = res["gbuffer"]
        sun_dir = _scene_sun_dir(ctx)
        data = csmops.render_cascades(ctx.gpu, ctx.vc, sun_dir, shadow_capacity,
                                      max_distance=csm_max_distance)
        if csm_debug or dv_csm:
            res["csm_data"] = data
        s = 2
        sh, sw = height // s, width // s
        mask = csmops.csm_shadow_mask(data, ctx.vc, gb.world_pos[::s, ::s][:sh, :sw],
                                      gb.geo_normal[::s, ::s][:sh, :sw],
                                      gb.valid[::s, ::s][:sh, :sw], sun_dir)
        mask = resize_bilinear(mask, height, width)
        res["sun_shadow"] = mask * sssops.screen_space_shadows(gb, ctx.vc, sun_dir)

    if mode != RenderingMode.NORMAL_BASIC:
        g.get("ShadowCSM").enabled = False

    @g.add
    @render_pass("IBL", reads=(), writes=("sky_irradiance",))
    def _ibl(ctx, res):
        """The ambient's SH irradiance: zero when the environment rides the
        light list, the environment map's (projected at load), else the
        procedural sky's, projected each frame."""
        if env_as_lights:
            res["sky_irradiance"] = torch.zeros((9, 3), dtype=torch.float32,
                                                device=ctx.gpu.device)
        elif ctx.gpu.env_sh is not None:
            res["sky_irradiance"] = ctx.gpu.env_sh
        else:
            res["sky_irradiance"] = iblops.build_sky_irradiance(_scene_sun_dir(ctx),
                                                                ctx.settings)

    @g.add
    @render_pass("RTXDI", reads=("gbuffer", "restir_reservoir"),
                 writes=("restir_direct", "restir_reservoir", "rt_overflow_di",
                         "rt_k3_lanes_di", "rt_k3_capped_di"),
                 persistent=("restir_reservoir",))
    def _rtxdi(ctx, res):
        """ReSTIR DI chain: candidates (from the presample tiles, or with
        ``regir`` from this frame's ReGIR cells), temporal and spatial
        reuse, one visibility ray per winner."""
        grid = None
        if regir:
            if regir_mode == "onion":
                grid = regirops.build_regir_onion(ctx.rt.lights, ctx.vc["camera_pos"],
                                                  scene_radius, ctx.vc["frame_index"])
            else:
                grid = regirops.build_regir_grid(ctx.rt.lights, scene_bounds[0],
                                                 scene_bounds[1], ctx.vc["frame_index"])
        so = {}
        direct, new_res = restirops.restir_di(
            ctx.gpu, ctx.rt, res["gbuffer"], ctx.vc, ctx.settings,
            res["restir_reservoir"], ctx.vc["frame_index"], visibility=True,
            regir_grid=grid, stats_out=so, num_candidates=rq.di_candidates,
            spatial_taps=rq.di_spatial_taps, boiling_mult=rq.di_boiling_mult,
            checkerboard=rq.di_checkerboard, vis_scale=rq.di_vis_scale)
        res["restir_direct"] = direct
        res["restir_reservoir"] = new_res
        res["rt_overflow_di"] = so["overflow"]
        res["rt_k3_lanes_di"] = so["k3_lanes"]
        res["rt_k3_capped_di"] = so["k3_capped"]

    if not use_restir:
        g.get("RTXDI").enabled = False

    @g.add
    @render_pass("RTXDIGI", reads=("gbuffer", "restir_gi_reservoir", "sky_irradiance"),
                 writes=("restir_indirect", "restir_gi_reservoir", "gi_traced") + GI_STATS,
                 persistent=("restir_gi_reservoir",))
    def _rtxdi_gi(ctx, res):
        """ReSTIR GI chain at quarter resolution; bounce hits add the
        sky-SH diffuse exitance."""
        so = {}
        ind, new_res = giops.restir_gi(
            ctx.gpu, ctx.rt, res["gbuffer"], ctx.vc, ctx.settings, res["restir_gi_reservoir"],
            ctx.vc["frame_index"], scale=GI_SCALE, half_rate=rq.gi_half_rate,
            trace_max_steps=GI_TRACE_STEPS, skip_pool_emissive=use_restir, stats_out=so,
            sky_sh=res["sky_irradiance"],
            ibl_scale=ctx.settings.ibl_intensity * ctx.settings.ambient_scale,
            spatial_taps=rq.gi_spatial_taps, m_clamp=rq.gi_m_clamp)
        res["restir_indirect"] = ind
        res["restir_gi_reservoir"] = new_res
        res["gi_traced"] = so["traced"]
        for name, key in zip(GI_STATS, ("overflow", "bounce_lanes", "bounce_capped",
                                        "nee_lanes", "nee_capped")):
            res[name] = so[key]

    if not use_restir_gi:
        g.get("RTXDIGI").enabled = False

    @g.add
    @render_pass("Denoise", reads=("restir_direct", "gbuffer", "denoise_state"),
                 writes=("restir_direct", "denoise_state"), persistent=("denoise_state",))
    def _denoise(ctx, res):
        """RELAX / REBLUR denoise of the stochastic direct signal."""
        out, st = dnops.denoise(res["restir_direct"], res["gbuffer"], res["denoise_state"],
                                profile=denoiser_profile)
        res["restir_direct"] = out
        res["denoise_state"] = st

    if not use_restir:
        g.get("Denoise").enabled = False

    def traced_bounce(ctx, res, scale, seed, salt, skip_pool_emissive, names):
        """The SHARC bounce of the 1/scale grid (ops/sharc_indirect.py); the
        walks' lanes and capped lanes go to the resources ``names``."""
        so = {}
        b = sharcind.bounce(ctx.gpu, ctx.rt, res["gbuffer"], ctx.vc, ctx.settings, scale, seed,
                            salt, skip_pool_emissive, res["sky_irradiance"], stats_out=so)
        for name, k in zip(names, ("lanes", "capped", "nee_lanes", "nee_capped")):
            res[name] = so[k]
        return b

    @g.add
    @render_pass("SHARC", reads=("gbuffer", "sharc_cache", "sky_irradiance"),
                 writes=("sharc_cache", "sharc_indirect") + SHARC_STATS,
                 persistent=("sharc_cache",))
    def _sharc(ctx, res):
        """SHARC radiance cache: a quarter-res cosine bounce updates it (the
        hit's emission, one NEE sample and sky exitance, plus the cache's
        own value at the hit's cell: one more bounce a frame), then the
        resolve (aging, eviction) and a full-res query."""
        gb = res["gbuffer"]
        cam = ctx.vc["camera_pos"]
        b = traced_bounce(ctx, res, sharcind.UPDATE_SCALE, sharcind.UPDATE_SEED,
                          sharcind.UPDATE_SALT, False, SHARC_STATS)
        cache = sharcind.update_cache(res["sharc_cache"], b, cam)
        res["sharc_cache"] = cache
        ind, _ = sharcops.sharc_query(cache, gb.world_pos.reshape(-1, 3),
                                      gb.normal.reshape(-1, 3), cam)
        res["sharc_indirect"] = ind.reshape(height, width, 3)

    if not use_sharc:
        g.get("SHARC").enabled = False

    @g.add
    @render_pass("SharcIndirectQuery",
                 reads=("gbuffer", "sharc_cache", "sky_irradiance", "sharc_q_state"),
                 writes=("sharc_indirect", "sharc_q_state") + SHARCQ_STATS,
                 persistent=("sharc_q_state",))
    def _sharc_query_traced(ctx, res):
        """The combined mode's indirect: one cosine bounce a half-res pixel
        whose hit adds its emission, NEE sample and sky exitance to the
        resolved cache's value at the hit's cell; demodulated by albedo,
        RELAX temporal + a 2-step A-trous at the half-res grid, then a
        depth/normal-guided upsample and the full-res albedo."""
        b = traced_bounce(ctx, res, sharcind.QUERY_SCALE, sharcind.QUERY_SEED,
                          sharcind.QUERY_SALT, use_restir, SHARCQ_STATS)
        res["sharc_indirect"], res["sharc_q_state"] = sharcind.query_indirect(
            res["gbuffer"], res["sharc_cache"], b, res["sharc_q_state"], ctx.vc["camera_pos"])

    if not use_sharc_traced:
        g.get("SharcIndirectQuery").enabled = False

    @g.add
    @render_pass("DDGI", reads=("gbuffer", "ddgi_volume"),
                 writes=("ddgi_indirect", "ddgi_volume", "ddgi_traced",
                         "rt_k3_lanes_ddgi", "rt_k3_capped_ddgi"),
                 persistent=("ddgi_volume",))
    def _ddgi(ctx, res):
        """DDGI probe volume: the probe-ray update (when the volume still
        changes, and every 8th frame), then a quarter-res irradiance query,
        depth/normal-guided upsampling."""
        gb = res["gbuffer"]
        vol = res["ddgi_volume"]
        frame = ctx.vc["frame_index"]
        # the gate reads the device's variability back to the host: one
        # sync per frame, skipped on the keep-alive frames
        traced = frame % 8 == 0 or bool(vol.variability > 0.01)
        so = {}
        if traced:
            vol = ddgiops.ddgi_update(vol, ctx.gpu, ctx.rt, ctx.settings, frame,
                                      stats_out=so)
        res["ddgi_traced"] = int(traced)
        zero = torch.zeros((), dtype=torch.int64, device=gb.depth.device)
        res["rt_k3_lanes_ddgi"] = so.get("k3_lanes", zero)
        res["rt_k3_capped_ddgi"] = so.get("k3_capped", zero)
        res["ddgi_indirect"] = ddgiops.ddgi_indirect(vol, gb)
        res["ddgi_volume"] = vol

    if not use_ddgi:
        g.get("DDGI").enabled = False

    @g.add
    @render_pass("SSGI", reads=("gbuffer", "taa_history", "ssgi_state")
                 + (("sky_irradiance",) if dv_ssgi else ()),
                 writes=("ssgi_indirect", "ssgi_state") + (("ssgi_debug",) if dv_ssgi else ()),
                 persistent=("ssgi_state",))
    def _ssgi(ctx, res):
        """Screen-space GI: a half-res march against last frame's lit HDR
        (the TAA history, brought to the render size under upscaling), then
        the RELAX chain; an ssgi_* debug view also keeps their
        intermediates."""
        gb = res["gbuffer"]
        prev = res["taa_history"]
        if upscale:
            prev = resize_bilinear(prev, height, width)
        dv = {} if dv_ssgi else None
        raw = ssgiops.ssgi_half_res(gb, ctx.vc, prev, ctx.vc["frame_index"], debug_out=dv,
                                    irr=res["sky_irradiance"] if dv_ssgi else None)
        res["ssgi_indirect"], res["ssgi_state"] = dnops.denoise(raw, gb, res["ssgi_state"],
                                                                debug_out=dv)
        if dv_ssgi:
            dv["composed"] = res["ssgi_indirect"]
            dv["view_dir"] = skyops.view_dirs_from_pixels(ctx.vc, height, width)
            res["ssgi_debug"] = dv

    if not use_ssgi:
        g.get("SSGI").enabled = False

    @g.add
    @render_pass("SpecularIndirect", reads=("gbuffer", "spec_state", "sky_irradiance")
                 + (("sharc_cache",) if use_sharc else ()),
                 writes=("spec_indirect", "spec_weight", "spec_state") + SPEC_STATS,
                 persistent=("spec_state",))
    def _spec_indirect(ctx, res):
        """GGX-VNDF reflection rays for glossy pixels: they replace the
        split-sum specular ambient where the roughness permits tracing."""
        so = {}
        spec, w_blend, st = specops.specular_indirect(
            ctx.gpu, ctx.rt, res["gbuffer"], ctx.vc, ctx.settings, res["spec_state"],
            ctx.vc["frame_index"], env_fn=None if env_as_lights else env_fn(ctx),
            sun_dir=_scene_sun_dir(ctx),
            sharc_cache=res["sharc_cache"] if use_sharc else None,
            skip_pool_emissive=use_restir, include_env_miss=not env_as_lights,
            sky_sh=res["sky_irradiance"],
            ibl_scale=ctx.settings.ibl_intensity * ctx.settings.ambient_scale,
            half_rate=rq.spec_half_rate, stats_out=so)
        res["spec_indirect"] = spec
        res["spec_weight"] = w_blend
        res["spec_state"] = st
        for name, key in zip(SPEC_STATS, ("lanes", "capped", "nee_lanes", "nee_capped",
                                          "past_cap")):
            res[name] = so[key]

    if not use_spec:
        g.get("SpecularIndirect").enabled = False

    # the sun's shadow mask, where a pass writes one (without a ray-tracing
    # scene the Normal and IBL modes shade the sun unshadowed, as the JAX graph)
    shadowed = not use_restir and (gates["use_sun_shadow"] or mode == RenderingMode.NORMAL_BASIC)

    @g.add
    @render_pass("DeferredLighting",
                 reads=("gbuffer", "sky_irradiance")
                 + (("restir_direct",) if use_restir else ())
                 + (("sun_shadow",) if shadowed else ())
                 + (("spec_indirect", "spec_weight") if use_spec else ())
                 + (("sharc_indirect",) if use_sharc else ())
                 + (("ddgi_indirect",) if use_ddgi else ())
                 + (("ssgi_indirect",) if use_ssgi else ())
                 + (("restir_indirect",) if use_restir_gi else ()),
                 writes=("hdr",))
    def _deferred(ctx, res):
        gb = res["gbuffer"]
        v = -skyops.view_dirs_from_pixels(ctx.vc, height, width)
        rough = gb.orm[..., 1]
        metal = gb.orm[..., 2]
        if use_restir:
            direct = res["restir_direct"]
        else:
            shadow_fn = None
            if shadowed:
                mask = res["sun_shadow"]
                sun_idx = ctx.gpu.meta["sun_index"]

                def shadow_fn(i, L, dist):
                    return mask if i == sun_idx else None
            direct = shadeops.shade_all_lights(ctx.gpu, gb.world_pos, gb.normal, v,
                                               gb.albedo, metal, rough,
                                               shadow_fn=shadow_fn)
        ibl_scale = ctx.settings.ibl_intensity * ctx.settings.ambient_scale * ibl_mult
        if env_as_lights:
            # the lights carry the environment (diffuse and specular)
            ambient = torch.zeros_like(gb.albedo)
        else:
            ambient = iblops.ibl_ambient(
                res["sky_irradiance"], gb.normal, v, gb.albedo, metal, rough,
                _scene_sun_dir(ctx), ctx.settings, intensity=ibl_scale, env_fn=env_fn(ctx),
                spec_suppress=res["spec_weight"] if use_spec else None,
                brdf_lut=ctx.gpu.brdf_lut)
        hdr = direct + ambient + gb.emissive
        if use_spec:
            hdr = hdr + res["spec_indirect"]
        if use_sharc:
            hdr = hdr + res["sharc_indirect"]
        if use_ssgi:
            hdr = hdr + res["ssgi_indirect"]
        if use_restir_gi:
            hdr = hdr + res["restir_indirect"]
        if use_ddgi:
            hdr = hdr + res["ddgi_indirect"]
        res["hdr"] = torch.where(gb.valid[..., None], hdr, 0.0)

    @g.add
    @render_pass("Sky", reads=("gbuffer", "hdr"), writes=("hdr",))
    def _sky(ctx, res):
        gb = res["gbuffer"]
        vdir = skyops.view_dirs_from_pixels(ctx.vc, height, width)
        if ctx.gpu.env_map is not None:
            sky = envops.sample_equirect(ctx.gpu.env_map, vdir)
        else:
            sky = skyops.sky_radiance_fast(vdir, _scene_sun_dir(ctx), ctx.settings)
        res["hdr"] = torch.where(gb.valid[..., None], res["hdr"], sky)

    @g.add
    @render_pass("Transparent", reads=("gbuffer", "hdr", "sky_irradiance"),
                 writes=("hdr",))
    def _transparent(ctx, res):
        """Forward transparency over the lit opaque frame."""
        res["hdr"] = transops.transparent_composite(
            ctx.gpu, ctx.vc, ctx.settings, res["gbuffer"], res["hdr"],
            width=width, height=height,
            transparent_capacity=transparent_capacity,
            sun_dir=_scene_sun_dir(ctx), sky_sh=res["sky_irradiance"],
            env_as_lights=env_as_lights, env_fn=env_fn(ctx),
            ibl_scale=ctx.settings.ibl_intensity * ctx.settings.ambient_scale * ibl_mult)

    if not has_transparent:
        g.get("Transparent").enabled = False

    @g.add
    @render_pass("TAA", reads=("hdr", "gbuffer", "taa_history", "taa_valid"),
                 writes=("hdr", "taa_history", "taa_valid"),
                 persistent=("taa_history", "taa_valid"))
    def _taa(ctx, res):
        """Temporal accumulation; upscaling to the output size when it
        differs from the render size (the post passes then run at the
        output size)."""
        if (ow, oh) != (width, height):
            out = taaops.taau_resolve(res["hdr"], res["taa_history"], res["gbuffer"].motion,
                                      res["taa_valid"], ctx.settings, ctx.vc["jitter"],
                                      oh, ow)
        else:
            out = taaops.taa_resolve(res["hdr"], res["taa_history"], res["gbuffer"].motion,
                                     res["taa_valid"], ctx.settings)
        # one tensor under both names: later passes only read it (Bloom
        # returns a new tensor), so the history is never overwritten
        res["hdr"] = out
        res["taa_history"] = out
        res["taa_valid"] = True

    @g.add
    @render_pass("AutoExposure", reads=("hdr",), writes=("exposure", "histogram"),
                 persistent=("exposure",))
    def _exposure(ctx, res):
        hist = postops.luminance_histogram(res["hdr"])
        res["histogram"] = hist
        res["exposure"] = postops.exposure_adapt(hist, res["exposure"], ctx.dt,
                                                 ctx.settings)

    @g.add
    @render_pass("Bloom", reads=("hdr",), writes=("hdr",))
    def _bloom(ctx, res):
        res["hdr"] = postops.bloom(res["hdr"], ctx.settings)

    @g.add
    @render_pass("Tonemap", reads=("hdr", "exposure"), writes=("ldr",))
    def _tonemap(ctx, res):
        res["ldr"] = postops.tonemap_to_output(res["hdr"], res["exposure"])

    # the debug overlays read render-size G-buffer data against the output
    # frame: native resolution only
    @g.add
    @render_pass("DDGIDebug", reads=("ldr", "ddgi_volume"), writes=("ldr",))
    def _ddgi_debug(ctx, res):
        """The probe view: live probes as dots of their mean irradiance, dead
        ones red."""
        res["ldr"] = ddgiops.ddgi_probe_overlay(res["ldr"], res["ddgi_volume"], ctx.vc)

    if not (use_ddgi and ddgi_debug) or upscale:
        g.get("DDGIDebug").enabled = False

    @g.add
    @render_pass("CSMDebug", reads=("ldr", "csm_data", "gbuffer"), writes=("ldr",))
    def _csm_debug(ctx, res):
        """The cascade view: a per-pixel cascade tint and the depth maps as
        thumbnails."""
        gb = res["gbuffer"]
        res["ldr"] = csmops.csm_debug_overlay(res["ldr"], res["csm_data"], ctx.vc,
                                              gb.world_pos, gb.valid)

    if not (csm_debug and mode == RenderingMode.NORMAL_BASIC) or upscale:
        g.get("CSMDebug").enabled = False

    @g.add
    @render_pass("TexResidencyDebug", reads=("ldr", "tex_clamp"), writes=("ldr",))
    def _tex_debug(ctx, res):
        """The texture-streaming residency heatmap: each textured pixel
        tinted by how many mips coarser its sample came back than its
        footprint asked for (green: the desired mip is resident, yellow
        about one mip short, red three or more)."""
        res["ldr"] = tex_residency_overlay(res["ldr"], res["tex_clamp"])

    if not want_tex_debug or upscale:
        g.get("TexResidencyDebug").enabled = False

    if debug_view:
        if debug_view not in dvops.ALL_VIEWS:
            raise ValueError(f"unknown --debug-view '{debug_view}' "
                             f"(one of {', '.join(dvops.ALL_VIEWS)})")
        if upscale:
            raise ValueError("--debug-view needs native resolution (no --render-scale)")
        if dv_csm and mode != RenderingMode.NORMAL_BASIC:
            raise ValueError("csm_* debug views need --mode normal_basic "
                             "(CSM is the NormalBasic sun-shadow path)")
        if dv_ssgi and not use_ssgi:
            raise ValueError("ssgi_* debug views need --indirect-mode ssgi")
        if dv_sharc and not (use_sharc or use_sharc_traced):
            raise ValueError("sharc_* debug views need --indirect-mode sharc/combined")

        @g.add
        @render_pass("DebugView", reads=("ldr", "gbuffer")
                     + (("csm_data", "sun_shadow") if dv_csm else ())
                     + (("ssgi_debug",) if dv_ssgi else ())
                     + (("sharc_cache", "sharc_indirect") if dv_sharc else ()),
                     writes=("ldr",))
        def _debug_view(ctx, res):
            """The named debug view (ops/debugview.py) in place of the
            frame."""
            gb = res["gbuffer"]
            res["ldr"] = to_ldr8(debug_view_image(ctx, res, gb, debug_view, height, width))

    return g


def to_ldr8(img):
    """A float [0, 1] debug image -> uint8 (clip(x, 0, 1) * 255 + 0.5)."""
    return (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def tex_residency_overlay(ldr, clamp):
    """TexResidencyDebug's body: ldr (H, W, 3) uint8, clamp (H, W) mips
    clamped away -> uint8."""
    t = torch.clamp(clamp / 3.0, 0.0, 1.0)
    heat = torch.stack([torch.clamp(2.0 * t, 0.0, 1.0), torch.clamp(2.0 - 2.0 * t, 0.0, 1.0),
                        torch.zeros_like(t)], -1)
    w = torch.where(clamp > 1e-3, 0.55, 0.22)[..., None]
    return to_ldr8(ldr.to(torch.float32) / 255.0 * (1.0 - w) + heat * w)


def debug_view_image(ctx, res, gb, name: str, height: int, width: int):
    """The DebugView pass's float image of view ``name`` from the frame's
    resources (csm_data and sun_shadow, ssgi_debug, or the SHARC cache and
    sharc_indirect)."""
    ldr_f = res["ldr"].to(torch.float32) / 255.0
    if name.startswith("csm_"):
        mid = torch.clamp(gb.material, min=0)
        masked = (ctx.gpu.mat_i[mid, MATI_ALPHA_MODE] == 1) & (gb.material >= 0)
        return dvops.csm_view(name, ldr_f, gb, res["csm_data"], ctx.vc, res["sun_shadow"],
                              masked=masked)
    if name.startswith("ssgi_"):
        return dvops.ssgi_view(name, ldr_f, gb, res["ssgi_debug"])
    cam = ctx.vc["camera_pos"]
    pos = gb.world_pos.reshape(-1, 3)
    nrm = gb.normal.reshape(-1, 3)
    _, hit = sharcops.sharc_query(res["sharc_cache"], pos, nrm, cam)
    dv = {"cell": sharcops._cell_key(pos, nrm, cam).reshape(height, width),
          "radiance": res["sharc_indirect"],
          "hit": hit.reshape(height, width).to(torch.float32)}
    return dvops.sharc_view(name, ldr_f, gb, dv)


def initial_frame_state(width: int, height: int, device, use_restir: bool = False,
                        indirect_mode: str = "none", scene_bounds=None,
                        specular_indirect: bool = False, out_width: int = None,
                        out_height: int = None) -> Dict[str, object]:
    """Persistent resources seed: exposure, HZB, TAA history (at the output
    size, which TAA upscaling makes larger than the render size); under ReSTIR
    the light reservoirs and the denoiser history; per ``indirect_mode`` the
    SHARC cache (and for "combined" its half-res denoiser history), the SSGI
    denoiser history, the DDGI volume (fitted to ``scene_bounds``) or the GI
    reservoirs; the specular denoiser history where SpecularIndirect can
    run (the JAX package's initial_frame_state)."""
    h0, w0, levels = hzbops.hzb_sizes(width, height)
    state = {
        "exposure": torch.tensor(1.0, dtype=torch.float32, device=device),
        "hzb": torch.zeros((levels, h0, w0), dtype=torch.float32, device=device),
        "taa_history": torch.zeros((out_height or height, out_width or width, 3),
                                   dtype=torch.float32, device=device),
        "taa_valid": False,
    }
    if use_restir:
        state["restir_reservoir"] = restirops.reservoir_init(height, width, device)
        state["denoise_state"] = dnops.denoise_init(height, width, device)
    if indirect_mode in ("sharc", "combined"):
        state["sharc_cache"] = sharcops.sharc_init(device)
    if indirect_mode == "combined":
        state["sharc_q_state"] = dnops.denoise_init(height // 2, width // 2, device)
    if indirect_mode == "ssgi":
        state["ssgi_state"] = dnops.denoise_init(height, width, device)
    if indirect_mode == "ddgi":
        lo, hi = scene_bounds
        state["ddgi_volume"] = ddgiops.ddgi_init(lo, hi, device)
    if indirect_mode == "restir":
        state["restir_gi_reservoir"] = giops.gi_reservoir_init(height // GI_SCALE,
                                                               width // GI_SCALE, device)
    if specular_indirect and indirect_mode in ("restir", "sharc", "ddgi", "combined"):
        state["spec_state"] = specops.spec_state_init(height, width, device)
    return state


class DeferredRenderer:
    """Builds the graph and carries the persistent FrameState across frames.
    ``out_width`` / ``out_height``: the output size (TAA upscales to it);
    ``execute_per_pass``: each pass runs and is timed on its own
    (RenderGraph.execute_per_pass, timings in ``graph.last_pass_timings``).
    ``keep`` names resources to keep from each frame in ``last_resources``.
    Under texture streaming (``gpu.tex_stream``) ``last_stats`` carries the
    frame's demand histogram as "tex_feedback" (a device tensor);
    ``tex_debug``, ``csm_debug``, ``ddgi_debug`` and ``debug_view`` are the
    debug overlays and views."""

    def __init__(self, gpu, width: int, height: int, rt, shadow_scale: int,
                 mode: str = RenderingMode.NORMAL, direct_mode: str = "simple",
                 indirect_mode: str = "none", restir_quality: str = "balanced",
                 denoiser_profile: str = "relax", specular_indirect: bool = False,
                 regir: bool = False, regir_mode: str = "onion", env_as_lights: bool = False,
                 out_width: int = None, out_height: int = None,
                 execute_per_pass: bool = False, tex_debug: bool = False,
                 csm_debug: bool = False, ddgi_debug: bool = False, debug_view: str = None):
        self.width, self.height = width, height
        self.streaming = gpu.tex_stream is not None
        self.out_width, self.out_height = out_width or width, out_height or height
        self.execute_per_pass = execute_per_pass
        self.rt = rt
        g = pass_gates(mode, direct_mode, indirect_mode, specular_indirect, rt is not None)
        self.use_restir, self.use_restir_gi = g["use_restir"], g["use_restir_gi"]
        self.use_sharc, self.use_sharc_traced = g["use_sharc"], g["use_sharc_traced"]
        self.use_ddgi, self.use_spec = g["use_ddgi"], g["use_spec"]
        m = gpu.meta
        cap = max(int(gpu.lod0_pair_capacity), 1)
        self.graph = build_deferred_graph(
            width, height, cap, mode=mode, has_masked=m["has_masked"],
            has_transparent=m["has_transparent"],
            masked_capacity=gpu.bucket_pair_capacity((1,)),
            transparent_capacity=gpu.bucket_pair_capacity((2,)),
            shadow_capacity=gpu.shadow_pair_capacity(
                csmops.CASCADE_LOD_BIAS[:csmops.NUM_CASCADES]),
            shadow_scale=shadow_scale, direct_mode=direct_mode,
            indirect_mode=indirect_mode, restir_quality=restir_quality,
            denoiser_profile=denoiser_profile, scene_radius=m["scene_radius"],
            specular_indirect=specular_indirect, with_rt_shadows=rt is not None,
            regir=regir, regir_mode=regir_mode, scene_bounds=m["scene_bounds"],
            env_as_lights=env_as_lights, out_width=self.out_width, out_height=self.out_height,
            streaming=self.streaming, tex_debug=tex_debug, csm_debug=csm_debug,
            ddgi_debug=ddgi_debug, debug_view=debug_view)
        self.state = initial_frame_state(width, height, gpu.device, self.use_restir,
                                         indirect_mode, m["scene_bounds"], specular_indirect,
                                         self.out_width, self.out_height)
        self.last_stats = {}
        self.keep = ()              # extra resource names to keep per frame
        self.last_resources = {}
        self.ddgi_traced_frames = 0
        self.gi_traced_frames = 0

    def render(self, gpu, vc, settings, dt: float = 1 / 60, view_proj=None):
        """One frame -> LDR (H, W, 3) uint8. ``view_proj`` (the host camera
        matrix the path tracer's reset compares) is not read here."""
        ctx = FrameContext(gpu=gpu, vc=vc, settings=settings, dt=dt, rt=self.rt)
        outputs = ["ldr", "raster_overflow", "visible_count", "occluded_count",
                   "phase2_count", "exposure"]
        if self.use_restir:
            outputs += ["rt_overflow_di", "rt_k3_lanes_di", "rt_k3_capped_di"]
        elif self.graph.get("SunShadow").enabled:
            outputs += ["rt_overflow_sun"]
        if self.use_ddgi:
            outputs += ["ddgi_traced", "rt_k3_lanes_ddgi", "rt_k3_capped_ddgi"]
        if self.use_restir_gi:
            outputs += ["gi_traced", *GI_STATS]
        if self.use_sharc:
            outputs += list(SHARC_STATS)
        if self.use_sharc_traced:
            outputs += list(SHARCQ_STATS)
        if self.use_spec:
            outputs += list(SPEC_STATS)
        if self.streaming:
            outputs += ["tex_feedback"]
        run = self.graph.execute_per_pass if self.execute_per_pass else self.graph.execute
        o = run(ctx, self.state, outputs=outputs + list(self.keep))
        self.last_resources = {k: o[k] for k in self.keep}
        self.last_stats = {"raster_overflow": o["raster_overflow"],
                           "visible_pairs": o["visible_count"],
                           "occluded_pairs": o["occluded_count"],
                           "phase2_pairs": o["phase2_count"],
                           "exposure": o["exposure"]}
        if self.use_restir:
            # under-reported occlusion: overflowed beam tiles + winner lanes
            # past the compaction capacities; K3 lanes and capped lanes
            self.last_stats.update(rt_overflow_di=o["rt_overflow_di"],
                                   rt_k3_lanes_di=o["rt_k3_lanes_di"],
                                   rt_k3_capped_di=o["rt_k3_capped_di"])
        elif "rt_overflow_sun" in o:
            self.last_stats["rt_overflow_tiles"] = o["rt_overflow_sun"]
        if self.use_ddgi:
            # traced frames so far; the NEE shadow rays of this frame's
            # update in K3 and those the step budget cut short
            self.ddgi_traced_frames += o["ddgi_traced"]
            self.last_stats.update(ddgi_traced_frames=self.ddgi_traced_frames,
                                   rt_k3_lanes_ddgi=o["rt_k3_lanes_ddgi"],
                                   rt_k3_capped_ddgi=o["rt_k3_capped_ddgi"])
        if self.use_restir_gi:
            # GI traced frames so far; this frame's final-visibility K4
            # overflow, the bounce and NEE walks' K3 lanes and capped lanes
            self.gi_traced_frames += o["gi_traced"]
            self.last_stats["gi_traced_frames"] = self.gi_traced_frames
            self.last_stats.update({k: o[k] for k in GI_STATS})
        # the SHARC bounces' and their NEE walks' K3 lanes and capped lanes;
        # the reflection and NEE walks, and the glossy lanes past the
        # compaction capacity (they read the sky)
        for use, names in ((self.use_sharc, SHARC_STATS), (self.use_sharc_traced, SHARCQ_STATS),
                           (self.use_spec, SPEC_STATS)):
            if use:
                self.last_stats.update({k: o[k] for k in names})
        if self.streaming:
            self.last_stats["tex_feedback"] = o["tex_feedback"]
        return o["ldr"]
