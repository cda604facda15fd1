"""Forward transparency over the lit opaque frame (counterpart of
hobbyrenderer_tpu/ops/transparent.py): the alpha-BLEND meshlets split into
far/near camera-distance bins, each rasterized, resolved and shaded on
lanes compacted off its visibility buffer, and composited far-first. On a
rank's row band the raster, resolve and shading run on the band, and the
refraction samples the gathered opaque frame (a refracted exit may land in
another band)."""

from __future__ import annotations

import torch

from hobbyrenderer_tpu_torch.ops import culling as cullops
from hobbyrenderer_tpu_torch.ops import ibl as iblops
from hobbyrenderer_tpu_torch.ops import raster as rasterops
from hobbyrenderer_tpu_torch.ops import refraction as refrops
from hobbyrenderer_tpu_torch.ops import shading as shadeops
from hobbyrenderer_tpu_torch.ops import sky as skyops
from hobbyrenderer_tpu_torch.scene.gpu import (MAT_ATTEN_COLOR, MAT_ATTEN_DIST,
                                               MAT_IOR, MAT_TRANSMISSION)


def transparent_composite(gpu, vc, settings, gb, hdr, *, width, height,
                          transparent_capacity, sun_dir, sky_sh, env_as_lights: bool = False,
                          env_fn=None, ibl_scale=1.0, y0: int = 0, shard_h: int = None,
                          hdr_full=None):
    """Render the scene's alpha-BLEND geometry over hdr; returns new hdr.
    ``env_fn`` (directions -> radiance): the environment map, for the
    ambient's reflections and refracted rays that leave the screen (else
    the procedural sky); ``env_as_lights``: the environment rides the light
    list, so the ambient term is dropped. A row band passes ``y0`` and
    ``shard_h`` (gb and hdr are frame rows [y0, y0 + shard_h)) and the
    gathered opaque frame ``hdr_full`` for the refraction."""
    dev = hdr.device
    shard_h = height if shard_h is None else shard_h
    if hdr_full is None:
        hdr_full = hdr
    cull = cullops.cull_pairs(gpu, vc, alpha_mask=(False, False, True))
    vdir = skyops.view_dirs_from_pixels(vc, shard_h, width, y0=y0, full_height=height)
    v = -vdir

    def miss_env(d):
        if env_fn is not None:
            return env_fn(d)
        return skyops.sky_radiance_fast(d, sun_dir, settings)

    stack = refrops.build_level_stack(hdr_full)
    R = shard_h * width
    CAP = max(R // 16, 2048)
    lane = torch.arange(R, device=dev)

    def shade_layer(hdr_band, slots):
        ro, attr = rasterops.rasterize(gpu, vc, slots, width, height, y0=y0,
                                       shard_height=shard_h)
        nearer = ro.depth > gb.depth
        # ---- compact covered lanes (index order) off the visibility buffer
        val = ((ro.visid >= 0) & nearer).reshape(R)
        rank = torch.cumsum(val.to(torch.int64), 0) - 1
        slot = torch.where(val & (rank < CAP), rank, CAP)
        sel = torch.full((CAP + 1,), R, dtype=torch.int64, device=dev)
        sel[slot[val]] = lane[val]
        sel = sel[:CAP]
        pad = sel >= R
        selc = torch.clamp(sel, max=R - 1)

        def take(a):
            flat = a.reshape((R,) + a.shape[2:])[selc]
            return torch.where(pad.reshape((-1,) + (1,) * (flat.ndim - 1)),
                               torch.zeros_like(flat), flat)

        vis_c = torch.where(pad, -1, ro.visid.reshape(R)[selc])
        dep_c = torch.where(pad, 0.0, ro.depth.reshape(R)[selc])
        ro_c = rasterops.RasterOutput(depth=dep_c.reshape(1, CAP),
                                      visid=vis_c.reshape(1, CAP),
                                      overflow=ro.overflow)
        attr_c = take(attr).reshape(1, CAP, attr.shape[-1])
        pids = (selc + y0 * width).reshape(1, CAP)         # global pixel ids
        tgb = rasterops.resolve_gbuffer(gpu, vc, ro_c, attr_c, pix_ids=pids)
        flat = lambda a: a.reshape((CAP,) + a.shape[2:])
        pos_c, n_c, alb_c = flat(tgb.world_pos), flat(tgb.normal), flat(tgb.albedo)
        em_c = flat(tgb.emissive)
        v_c = take(v)
        rough_c = flat(tgb.orm)[..., 1]
        metal_c = flat(tgb.orm)[..., 2]
        alpha_c = torch.clamp(flat(tgb.alpha), 0.0, 1.0)[..., None]

        direct = shadeops.shade_all_lights(gpu, pos_c, n_c, v_c, alb_c,
                                           metal_c, rough_c)
        if env_as_lights:
            ambient = torch.zeros_like(alb_c)
        else:
            ambient = iblops.ibl_ambient(sky_sh, n_c, v_c, alb_c, metal_c, rough_c,
                                         sun_dir, settings, intensity=ibl_scale,
                                         env_fn=env_fn, brdf_lut=gpu.brdf_lut)
        shaded = direct + ambient
        mf = gpu.mat_f[torch.clamp(flat(tgb.material), min=0)]
        transmission = mf[..., MAT_TRANSMISSION][..., None]
        atten = mf[..., MAT_ATTEN_COLOR:MAT_ATTEN_COLOR + 3]
        vdir_c = take(vdir)
        opq_c = torch.where(take(gb.valid)[..., None], take(gb.world_pos),
                            pos_c + vdir_c)
        pix_uv = torch.stack([((selc % width).to(torch.float32) + 0.5) / width,
                              ((selc // width + y0).to(torch.float32) + 0.5) / height], -1)
        bg_refr = refrops.refracted_background(
            vc, pos_c, opq_c, n_c, vdir_c, mf[..., MAT_IOR], rough_c, atten,
            mf[..., MAT_ATTEN_DIST], ~pad, stack=stack, pix_uv=pix_uv,
            miss_fn=miss_env)
        cov_c = torch.maximum(alpha_c, transmission)
        surf_c = em_c + transmission * bg_refr + (1.0 - transmission) * shaded
        blend_c = torch.where(pad[:, None], 0.0, surf_c * cov_c)
        cov_c = torch.where(pad[:, None], 0.0, cov_c)
        # ---- scatter back (padding lanes land in the dropped row R)
        surf = torch.zeros((R + 1, 3), dtype=hdr_band.dtype, device=dev)
        surf[sel] = blend_c
        cov = torch.zeros((R + 1, 1), dtype=hdr_band.dtype, device=dev)
        cov[sel] = cov_c
        surf = surf[:R].reshape(shard_h, width, 3)
        cov = cov[:R].reshape(shard_h, width, 1)
        return hdr_band * (1.0 - cov) + surf

    dist = torch.linalg.vector_norm(cull["ml_center_world"] - vc["camera_pos"][None, :],
                                    dim=-1)
    live = cull["mask"]
    d_min = torch.amin(torch.where(live, dist, float("inf")))
    d_max = torch.amax(torch.where(live, dist, float("-inf")))
    thresh = 0.5 * (d_min + d_max)
    far_mask = live & (dist >= thresh)
    near_mask = live & (dist < thresh)
    slots_far, _ = cullops.compact_mask(far_mask, transparent_capacity)
    slots_near, _ = cullops.compact_mask(near_mask, transparent_capacity)
    hdr = shade_layer(hdr, slots_far)
    return shade_layer(hdr, slots_near)
