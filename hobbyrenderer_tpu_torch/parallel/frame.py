"""Multi-GPU deferred frame: the framebuffer split into row bands, one a
rank (counterpart of hobbyrenderer_tpu/parallel/frame.py).

- Scene buffers and culling are replicated: every rank culls the whole
  scene (cheap next to the pixel work).
- Raster, G-buffer resolve, lighting and sky run on the rank's band of tile
  rows: the worklist bins only the band's tiles, and K1 takes the band's
  first tile row, so the band's raster rows are the whole frame's bit for
  bit.
- The luminance histogram is summed over the ranks (Mesh.psum_int), the
  HDR bands are gathered, and bloom and tonemap run replicated: every rank
  returns the whole LDR frame.
- ``with_csm``: cascaded sun shadows. The cascade atlas (one K5 call, tile
  row origin 0) is the same on every rank, so every rank renders it; only
  the half-res PCF mask is evaluated on the band. The screen-space contact
  shadows stay single-device (their sunward march crosses bands)."""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from hobbyrenderer_tpu_torch.ops import csm as csmops
from hobbyrenderer_tpu_torch.ops import culling as cullops
from hobbyrenderer_tpu_torch.ops import ibl as iblops
from hobbyrenderer_tpu_torch.ops import post as postops
from hobbyrenderer_tpu_torch.ops import raster as rasterops
from hobbyrenderer_tpu_torch.ops import shading as shadeops
from hobbyrenderer_tpu_torch.ops import sky as skyops
from hobbyrenderer_tpu_torch.ops.raster import TILE
from hobbyrenderer_tpu_torch.ops.resize import resize_bilinear
from hobbyrenderer_tpu_torch.ops.shard_utils import make_row_shard
from hobbyrenderer_tpu_torch.parallel.mesh import build_mesh


def sun_dir(gpu, settings):
    """The first directional light's direction, else the settings' sun."""
    m = gpu.meta
    if m["has_sun"]:
        return gpu.light_dir[m["sun_index"]]
    return torch.tensor(settings.sun_direction, dtype=torch.float32, device=gpu.device)


class BandedRenderer:
    """What the row-band renderers share: the mesh, this rank's band, and a
    ``stage_hook`` (name -> context manager) wrapped around each stage of a
    frame, for a caller that times or counts them (no-op by default)."""

    def __init__(self, width: int, height: int, n_devices: int, mesh, row_multiple: int):
        self.mesh = mesh if mesh is not None else build_mesh(n_devices)
        n = self.mesh.n
        if height % (n * row_multiple):
            raise ValueError(f"height {height} must be a multiple of n_devices * "
                             f"{row_multiple} = {n * row_multiple}")
        self.width, self.height = width, height
        self.n = n
        self.shard_h = height // n
        self.shard = make_row_shard(self.mesh, self.shard_h)
        self.stage_hook = lambda name: contextlib.nullcontext()

    def _stage(self, name: str):
        return self.stage_hook(name)


class DeferredShardedRenderer(BandedRenderer):
    """The deferred frame (simple direct light, IBL ambient, sky; with
    ``with_csm`` cascaded sun shadows) on n ranks: render(gpu, vc, settings,
    dt) -> the whole LDR frame (H, W, 3) uint8 on every rank."""

    def __init__(self, gpu, width: int, height: int, n_devices: int = 0, mesh=None,
                 with_csm: bool = False):
        super().__init__(width, height, n_devices, mesh, TILE)
        self.capacity = max(int(gpu.lod0_pair_capacity), 1)
        self.shadow_capacity = 0
        if with_csm:
            self.shadow_capacity = max(int(gpu.shadow_pair_capacity(
                csmops.CASCADE_LOD_BIAS[:csmops.NUM_CASCADES])), 1)
        # the CSM range follows the scene's bounding sphere (models/deferred.py)
        self.csm_max_distance = float(min(max(2.0 * gpu.meta["scene_radius"], 20.0), 400.0))
        self.state: Dict[str, torch.Tensor] = {
            "exposure": torch.tensor(1.0, dtype=torch.float32, device=self.mesh.device)}

    def render(self, gpu, vc, settings, dt: float = 1 / 60, view_proj=None):
        sh, W, H = self.shard, self.width, self.height
        h, y0 = sh.shard_h, sh.y0
        with self._stage("Culling"):
            cull = cullops.cull_pairs(gpu, vc, alpha_mask=(True, True, False))
            slots, _ = cullops.compact_mask(cull["mask"], self.capacity)
        with self._stage("Raster"):
            ro, attr = rasterops.rasterize(gpu, vc, slots, W, H, y0=y0, shard_height=h)
            gb = rasterops.resolve_gbuffer(gpu, vc, ro, attr, y0=y0)
        with self._stage("Lighting"):
            vdir = skyops.view_dirs_from_pixels(vc, h, W, y0=y0, full_height=H)
            v = -vdir
            rough, metal = gb.orm[..., 1], gb.orm[..., 2]
            sun = sun_dir(gpu, settings)
            shadow_fn = None
            if self.shadow_capacity > 0:
                data = csmops.render_cascades(gpu, vc, sun, self.shadow_capacity,
                                              max_distance=self.csm_max_distance)
                s = 2
                hs, ws = h // s, W // s
                m = csmops.csm_shadow_mask(data, vc, gb.world_pos[::s, ::s][:hs, :ws],
                                           gb.geo_normal[::s, ::s][:hs, :ws],
                                           gb.valid[::s, ::s][:hs, :ws], sun)
                mask = resize_bilinear(m, h, W)
                sun_idx = gpu.meta["sun_index"]

                def shadow_fn(i, L, dist):
                    return mask if i == sun_idx else None
            direct = shadeops.shade_all_lights(gpu, gb.world_pos, gb.normal, v, gb.albedo,
                                               metal, rough, shadow_fn=shadow_fn)
            irr = iblops.build_sky_irradiance(sun, settings)
            ambient = iblops.ibl_ambient(irr, gb.normal, v, gb.albedo, metal, rough, sun,
                                         settings,
                                         intensity=settings.ibl_intensity * settings.ambient_scale)
            hdr = torch.where(gb.valid[..., None], direct + ambient + gb.emissive,
                              skyops.sky_radiance_fast(vdir, sun, settings))
        with self._stage("Post"):
            hist = self.mesh.psum_int(postops.luminance_histogram(hdr))
            exposure = postops.exposure_adapt(hist, self.state["exposure"], dt, settings)
            hdr_full = postops.bloom(self.mesh.all_gather_rows(hdr), settings)
            ldr = postops.tonemap_to_output(hdr_full, exposure)
        self.state["exposure"] = exposure
        return ldr
