"""Multi-GPU flagship frame: the Normal-mode chain on row bands, one a rank
(counterpart of hobbyrenderer_tpu/parallel/flagship.py):

  culling (replicated) -> banded raster + G-buffer resolve -> ReSTIR DI
  with halo'd temporal and spatial reuse -> RELAX denoise (halo'd
  A-trous) -> indirect: ReSTIR GI on the banded GI grid, SSGI marching the
  gathered depth and previous frame, combined SHARC (the cache replicated,
  updated from the gathered samples) or DDGI (the probe volume
  replicated) -> traced specular -> lighting + sky -> transparency
  (banded raster and shading; the refraction reads the gathered opaque
  frame) -> TAA (halo'd history) -> exposure (histogram summed over the
  ranks) -> banded bloom + tonemap -> the uint8 LDR gathered.

Every screen-space pass reaches its out-of-band taps through
ops/shard_utils.extend_rows; every RNG key is a global pixel id, so a band
draws the single-device frame's samples. Two things are per band, as in the
JAX package: the visibility capacities of ReSTIR DI (max(R // 32, 1024)
straggler lanes, R the band's pixels) and the 32x32 ray tiles of the
reduced-rate DI grid and the GI grid, so a sharded frame differs from the
single-device one where those bind. Two more differences are the JAX
package's too: past the frame's top and bottom the halo rows are zeros,
which the A-trous, spatial-reuse and TAA taps read (one device reads the
edge row), and the banded bloom's pyramid stops at the first odd band
height (ops/post.py::bloom_sharded).

The state (reservoirs, denoiser and TAA histories) is this rank's band;
the exposure, the TAA-valid flag, the SHARC cache and the DDGI volume are
replicated. Under texture streaming
each band resolves its own demand histogram and ``last_tex_feedback`` is
their sum over the ranks."""

from __future__ import annotations

from typing import Dict

import torch

from hobbyrenderer_tpu_torch.ops import culling as cullops
from hobbyrenderer_tpu_torch.ops import ddgi as ddgiops
from hobbyrenderer_tpu_torch.ops import denoise as dnops
from hobbyrenderer_tpu_torch.ops import ibl as iblops
from hobbyrenderer_tpu_torch.ops import post as postops
from hobbyrenderer_tpu_torch.ops import raster as rasterops
from hobbyrenderer_tpu_torch.ops import restir as restirops
from hobbyrenderer_tpu_torch.ops import restir_gi as giops
from hobbyrenderer_tpu_torch.ops import sharc as sharcops
from hobbyrenderer_tpu_torch.ops import sharc_indirect as sharcind
from hobbyrenderer_tpu_torch.ops import sky as skyops
from hobbyrenderer_tpu_torch.ops import specular as specops
from hobbyrenderer_tpu_torch.ops import ssgi as ssgiops
from hobbyrenderer_tpu_torch.ops import taa as taaops
from hobbyrenderer_tpu_torch.ops import transparent as transops
from hobbyrenderer_tpu_torch.ops.raster import TILE
from hobbyrenderer_tpu_torch.parallel.frame import BandedRenderer, sun_dir

GI_SCALE = 4
GI_HALF_RATE = True    # the GI bounce traces on even frames (preset gi_half_rate)
DI_VIS_SCALE = 2       # reduced-rate winner visibility (preset di_vis_scale)
SPEC_HALF_RATE = True  # traced-specular checkerboard (preset spec_half_rate)
GI_TRACE_STEPS = 512
INDIRECT_MODES = ("restir", "ssgi", "sharc", "ddgi", "none")


def sharc_indirect_band(gpu, rt, gb, vc, settings, cache, q_state, irr, shard):
    """The combined SHARC indirect on a row band (models/deferred.py's SHARC
    and SharcIndirectQuery passes, through ops/sharc_indirect.py): the
    quarter-res update samples of every band gathered in the whole frame's
    row order update the replicated cache; the half-res traced query, RELAX
    and the guided upsample run on the band. Returns (indirect (h, W, 3),
    the new cache, the band's new query denoiser state)."""
    cam = vc["camera_pos"]
    b = sharcind.bounce(gpu, rt, gb, vc, settings, sharcind.UPDATE_SCALE, sharcind.UPDATE_SEED,
                        sharcind.UPDATE_SALT, False, irr, shard)
    cache = sharcind.update_cache(cache, b, cam, shard)
    b = sharcind.bounce(gpu, rt, gb, vc, settings, sharcind.QUERY_SCALE, sharcind.QUERY_SEED,
                        sharcind.QUERY_SALT, True, irr, shard)
    ind, st = sharcind.query_indirect(gb, cache, b, q_state, cam, shard)
    return ind, cache, st


def ddgi_indirect_band(gpu, rt, gb, vc, settings, vol, shard):
    """DDGI on a row band (models/deferred.py's DDGI pass): the probe volume
    is replicated (its update reads no screen data, so every rank runs the
    same deterministic update and the volumes stay equal), the quarter-res
    query and the guided upsample run on the band (ops/ddgi.py::
    ddgi_indirect). Returns (indirect, vol)."""
    frame = vc["frame_index"]
    # the gate reads the (replicated) variability: the same on every rank
    if frame % 8 == 0 or bool(vol.variability > 0.01):
        vol = ddgiops.ddgi_update(vol, gpu, rt, settings, frame)
    return ddgiops.ddgi_indirect(vol, gb, shard), vol


class FlagshipShardedRenderer(BandedRenderer):
    """The flagship (Normal-mode) frame on n ranks: render(gpu, vc, settings,
    dt) -> the whole LDR frame (H, W, 3) uint8 on every rank. ``rt`` (the
    ray-tracing scene) enables winner visibility, ReSTIR GI and the traced
    specular. ``indirect``: "restir" | "sharc" | "ddgi" (each needs rt) |
    "ssgi" (marches the gathered depth and previous frame) | "none".
    ``straggler_steps``: restir_di's K3 budget for the straggler and
    mismatch walks (None: every straggler traced, uncapped)."""

    def __init__(self, gpu, width: int, height: int, rt=None, n_devices: int = 0,
                 with_gi: bool = None, mesh=None, with_transparent: bool = None,
                 indirect: str = "restir", with_spec: bool = None,
                 straggler_steps=restirops.STRAGGLER_STEPS):
        if indirect not in INDIRECT_MODES:
            raise ValueError(f"unknown indirect mode '{indirect}' for the sharded flagship "
                             f"({' | '.join(INDIRECT_MODES)})")
        super().__init__(width, height, n_devices, mesh, TILE)
        if self.shard_h % GI_SCALE:
            raise ValueError(f"the band height {self.shard_h} must be a multiple of {GI_SCALE}")
        self.rt = rt
        self.indirect = indirect
        self.with_spec = (rt is not None) if with_spec is None else with_spec
        self.with_gi = (rt is not None) if with_gi is None else with_gi
        if with_transparent is None:
            with_transparent = gpu.meta["has_transparent"]
        self.with_transparent = with_transparent
        self.straggler_steps = straggler_steps
        self.capacity = max(int(gpu.lod0_pair_capacity), 1)
        h, W, dev = self.shard_h, width, self.mesh.device
        self.state: Dict[str, object] = {
            "exposure": torch.tensor(1.0, dtype=torch.float32, device=dev),
            "taa_valid": False,
            "taa_history": torch.zeros((h, W, 3), dtype=torch.float32, device=dev),
            "restir_reservoir": restirops.reservoir_init(h, W, dev),
            "denoise_state": dnops.denoise_init(h, W, dev),
        }
        if self.with_gi and indirect == "restir":
            self.state["restir_gi_reservoir"] = giops.gi_reservoir_init(
                h // GI_SCALE, W // GI_SCALE, dev)
        if indirect == "sharc" and rt is not None:
            self.state["sharc_cache"] = sharcops.sharc_init(dev)       # replicated
            self.state["sharc_q_state"] = dnops.denoise_init(h // 2, W // 2, dev)
        if indirect == "ddgi" and rt is not None:
            lo, hi = gpu.meta["scene_bounds"]
            self.state["ddgi_volume"] = ddgiops.ddgi_init(lo, hi, dev)   # replicated
        if self.with_spec and rt is not None:
            self.state["spec_state"] = specops.spec_state_init(h, W, dev)
        self.last_tex_feedback = None
        self.last_stats = {}

    def render(self, gpu, vc, settings, dt: float = 1 / 60, view_proj=None):
        sh, W, H, rt, st = self.shard, self.width, self.height, self.rt, self.state
        h, y0 = sh.shard_h, sh.y0
        frame = vc["frame_index"]
        ibl_scale = settings.ibl_intensity * settings.ambient_scale
        new = dict(st)
        with self._stage("Culling"):
            cull = cullops.cull_pairs(gpu, vc, alpha_mask=(True, True, False))
            slots, _ = cullops.compact_mask(cull["mask"], self.capacity)
        with self._stage("Raster"):
            streaming = gpu.tex_stream is not None
            ro, attr = rasterops.rasterize(gpu, vc, slots, W, H, y0=y0, shard_height=h)
            gb = rasterops.resolve_gbuffer(gpu, vc, ro, attr, y0=y0, want_feedback=streaming)
            if streaming:
                gb, fb = gb
                # the band's pixel ids are global: the sum is the frame's feedback
                self.last_tex_feedback = self.mesh.psum_int(fb)
        with self._stage("RTXDI"):
            so = {}
            direct, new["restir_reservoir"] = restirops.restir_di(
                gpu, rt, gb, vc, settings, st["restir_reservoir"], frame,
                visibility=rt is not None, shard=sh, vis_scale=DI_VIS_SCALE,
                straggler_steps=self.straggler_steps, stats_out=so)
        with self._stage("Denoise"):
            direct, new["denoise_state"] = dnops.denoise(direct, gb, st["denoise_state"],
                                                         shard=sh)
        sun = sun_dir(gpu, settings)
        irr = iblops.build_sky_irradiance(sun, settings)
        indirect = 0.0
        if self.indirect == "restir" and self.with_gi:
            with self._stage("RTXDIGI"):
                indirect, new["restir_gi_reservoir"] = giops.restir_gi(
                    gpu, rt, gb, vc, settings, st["restir_gi_reservoir"], frame,
                    scale=GI_SCALE, shard=sh, half_rate=GI_HALF_RATE,
                    trace_max_steps=GI_TRACE_STEPS, skip_pool_emissive=True, sky_sh=irr,
                    ibl_scale=ibl_scale)
        elif self.indirect == "ssgi":
            with self._stage("SSGI"):
                # the march lands anywhere on the screen: it taps the
                # gathered depth and last frame
                indirect = ssgiops.ssgi_half_res(
                    gb, vc, None, frame, shard=sh,
                    depth_full=self.mesh.all_gather_rows(gb.depth),
                    prev_hdr_full=self.mesh.all_gather_rows(st["taa_history"]))
        elif self.indirect == "sharc" and rt is not None:
            with self._stage("SHARC"):
                indirect, new["sharc_cache"], new["sharc_q_state"] = sharc_indirect_band(
                    gpu, rt, gb, vc, settings, st["sharc_cache"], st["sharc_q_state"], irr, sh)
        elif self.indirect == "ddgi" and rt is not None:
            with self._stage("DDGI"):
                indirect, new["ddgi_volume"] = ddgi_indirect_band(
                    gpu, rt, gb, vc, settings, st["ddgi_volume"], sh)
        spec = None
        if self.with_spec and rt is not None:
            with self._stage("SpecularIndirect"):
                spec, spec_w, new["spec_state"] = specops.specular_indirect(
                    gpu, rt, gb, vc, settings, st["spec_state"], frame, sun_dir=sun, shard=sh,
                    skip_pool_emissive=True, sky_sh=irr, ibl_scale=ibl_scale,
                    sharc_cache=new.get("sharc_cache"), half_rate=SPEC_HALF_RATE)
        with self._stage("Lighting"):
            vdir = skyops.view_dirs_from_pixels(vc, h, W, y0=y0, full_height=H)
            v = -vdir
            ambient = iblops.ibl_ambient(irr, gb.normal, v, gb.albedo, gb.orm[..., 2],
                                         gb.orm[..., 1], sun, settings, intensity=ibl_scale,
                                         spec_suppress=spec_w if spec is not None else None)
            hdr = direct + ambient + gb.emissive + indirect
            if spec is not None:
                hdr = hdr + spec
            hdr = torch.where(gb.valid[..., None], hdr,
                              skyops.sky_radiance_fast(vdir, sun, settings))
        if self.with_transparent:
            with self._stage("Transparent"):
                hdr = transops.transparent_composite(
                    gpu, vc, settings, gb, hdr, width=W, height=H,
                    transparent_capacity=self.capacity, sun_dir=sun, sky_sh=irr,
                    ibl_scale=ibl_scale, y0=y0, shard_h=h,
                    hdr_full=self.mesh.all_gather_rows(hdr))
        with self._stage("TAA"):
            hdr = taaops.taa_resolve(hdr, st["taa_history"], gb.motion, st["taa_valid"],
                                     settings, shard=sh)
            new["taa_history"], new["taa_valid"] = hdr, True
        with self._stage("Post"):
            hist = self.mesh.psum_int(postops.luminance_histogram(hdr))
            new["exposure"] = postops.exposure_adapt(hist, st["exposure"], dt, settings)
            hdr = postops.bloom_sharded(hdr, settings, sh, full_h=H)
            ldr = self.mesh.all_gather_rows(postops.tonemap_to_output(hdr, new["exposure"]))
        self.state = new
        self.last_stats = {"rt_overflow_di": so.get("overflow"),
                           "rt_k3_lanes_di": so.get("k3_lanes"),
                           "rt_k3_capped_di": so.get("k3_capped")}
        return ldr
