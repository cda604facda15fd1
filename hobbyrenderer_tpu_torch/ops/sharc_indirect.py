"""The SHARC indirect's traced bounces, shared by the deferred frame's SHARC
and SharcIndirectQuery passes (models/deferred.py) and the sharded
flagship's SHARC band (parallel/flagship.py).

A bounce is one cosine-distributed ray a pixel of a 1/s subsampled grid,
keyed on the global grid pixel id, traced on the bvh16 walk (K3 under
SHARC_TRACE_STEPS), with the outgoing radiance at each hit (emission, one
NEE sample, sky exitance). The quarter-res bounce updates the cache; the
combined mode's half-res bounce adds the resolved cache's value at each
hit, then RELAX and a guided upsample at the half-res grid. ``shard`` is
this rank's row band (ops/shard_utils.RowShard), or None for the whole
frame on one device."""

from __future__ import annotations

from typing import NamedTuple

import torch

from hobbyrenderer_tpu_torch.ops import denoise as dnops
from hobbyrenderer_tpu_torch.ops import sampling as smp
from hobbyrenderer_tpu_torch.ops import sharc as sharcops
from hobbyrenderer_tpu_torch.ops import trace as traceops
from hobbyrenderer_tpu_torch.ops.intersect import offset_ray_origin
from hobbyrenderer_tpu_torch.ops.restir_gi import _hit_radiance
from hobbyrenderer_tpu_torch.ops.shard_utils import global_y0, sub_shard
from hobbyrenderer_tpu_torch.ops.specular import _SubGB
from hobbyrenderer_tpu_torch.ops.upsample import joint_bilateral_upsample
from hobbyrenderer_tpu_torch.utils.rng import pcg3d, uniform_from_bits

SHARC_TRACE_STEPS = 512   # the SHARC bounces' 4-ary step budget (K3: 128 steps)
UPDATE_SCALE, UPDATE_SEED, UPDATE_SALT = 4, 55, 0x5A4C   # the cache update's bounce
QUERY_SCALE, QUERY_SEED, QUERY_SALT = 2, 77, 0xC0B1      # the combined mode's bounce


class Bounce(NamedTuple):
    sh: int                 # the grid's rows (of the band)
    sw: int                 # the grid's columns
    pos: torch.Tensor       # (R, 3) the grid's points
    nrm: torch.Tensor       # (R, 3) their shading normals
    alb: torch.Tensor       # (R, 3) their albedo
    val: torch.Tensor       # (R,) bool: G-buffer coverage
    hit: object             # the rays' closest hits (HitRecord)
    hpos: torch.Tensor      # (R, 3) the hits' positions
    hn: torch.Tensor        # (R, 3) the hits' shading normals
    rad: torch.Tensor       # (R, 3) the hits' outgoing radiance


def bounce(gpu, rt, gb, vc, settings, s: int, seed: int, salt: int, skip_pool_emissive,
           sky_sh, shard=None, stats_out: dict = None) -> Bounce:
    """The bounce of the (band's) 1/s grid of G-buffer ``gb``; ``seed``
    keys the directions, ``salt`` the hits' NEE samples. ``stats_out``
    gets the walks' lanes and capped lanes and those of the NEE rays
    (``lanes``, ``capped``, ``nee_lanes``, ``nee_capped``)."""
    H, W = gb.depth.shape
    sh, sw = H // s, W // s

    def sub(img):
        return img[::s, ::s][:sh, :sw]
    pos, nrm = sub(gb.world_pos).reshape(-1, 3), sub(gb.normal).reshape(-1, 3)
    gn = sub(gb.geo_normal).reshape(-1, 3)
    val = sub(gb.valid).reshape(-1)
    frame = vc["frame_index"]
    pix = (torch.arange(pos.shape[0], dtype=torch.int64, device=pos.device)
           + (global_y0(shard) // s) * sw)
    bits = pcg3d(torch.stack([pix, torch.full_like(pix, frame), torch.full_like(pix, seed)], -1))
    d = smp.to_world(nrm, smp.cosine_sample_hemisphere(uniform_from_bits(bits[..., 0]),
                                                       uniform_from_bits(bits[..., 1])))
    o = offset_ray_origin(pos, gn, d) + gn * settings.shadow_bias
    hit, so = traceops.closest_hit_counted(rt, o, d, val, max_steps=SHARC_TRACE_STEPS)
    nee = {}
    hpos, hn, rad = _hit_radiance(gpu, rt, rt.lights, hit, o, d, pix + salt, frame,
                                  stats_out=nee, skip_pool_emissive=skip_pool_emissive,
                                  sky_sh=sky_sh,
                                  ibl_scale=settings.ibl_intensity * settings.ambient_scale)
    if stats_out is not None:
        stats_out.update(lanes=so["lanes"], capped=so["capped"], nee_lanes=nee["k3_lanes"],
                         nee_capped=nee["k3_capped"])
    return Bounce(sh, sw, pos, nrm, sub(gb.albedo).reshape(-1, 3), val, hit, hpos, hn, rad)


def update_cache(cache, b: Bounce, cam, shard=None):
    """The cache updated from bounce ``b`` and resolved (aging, eviction).
    A sample is albedo * (hit radiance + the cache's value at the hit's
    cell: one more bounce a frame); a miss adds nothing (the IBL ambient
    covers the sky). Under a shard every band's samples are gathered in the
    whole frame's row order, so every rank runs the same deterministic
    update and the replicated caches stay equal with no merge."""
    fb, fb_hit = sharcops.sharc_query(cache, b.hpos, b.hn, cam)
    sample = torch.where((b.hit.tri < 0)[..., None], 0.0,
                         b.alb * (b.rad + torch.where(fb_hit[..., None], fb, 0.0)))
    pos, nrm, val = b.pos, b.nrm, b.val
    if shard is not None:
        pack = torch.cat([pos, nrm, sample, val.to(torch.float32)[..., None]], -1)
        pf = shard.mesh.all_gather_rows(pack.reshape(b.sh, b.sw, 10)).reshape(-1, 10)
        pos, nrm, sample, val = pf[:, 0:3], pf[:, 3:6], pf[:, 6:9], pf[:, 9] > 0.5
    return sharcops.sharc_resolve(sharcops.sharc_update(cache, pos, nrm, sample, val, cam))


def query_indirect(gb, cache, b: Bounce, q_state, cam, shard=None):
    """The combined mode's indirect from the half-res bounce ``b``: the hit
    radiance plus the resolved cache's value at the hit's cell, demodulated
    by albedo, RELAX temporal + a 2-step A-trous at the half-res grid, then
    a depth/normal-guided upsample and the full-res albedo. Returns
    (indirect (h, W, 3), the new half-res denoiser state)."""
    s = QUERY_SCALE
    fb, fb_ok = sharcops.sharc_query(cache, b.hpos, b.hn, cam)
    hit_ok = b.hit.tri >= 0
    rad = b.rad + torch.where((fb_ok & hit_ok)[..., None], fb, 0.0)
    irr = torch.where((b.val & hit_ok)[..., None], rad, 0.0).reshape(b.sh, b.sw, 3)
    qshard = sub_shard(shard, s, b.sh)

    def sub(img):
        return img[::s, ::s][:b.sh, :b.sw]
    sgb = _SubGB(motion=sub(gb.motion) / float(s), depth=sub(gb.depth),
                 normal=sub(gb.normal), valid=sub(gb.valid))
    color, var, st = dnops.temporal_accumulate(irr, sgb, q_state, shard=qshard)
    color = dnops.atrous_filter(color, var, sgb, iterations=2, shard=qshard)
    full_irr = joint_bilateral_upsample(color, sgb.depth, sgb.normal, sgb.valid, gb.depth,
                                        gb.normal, s, shard=shard)
    return torch.where(gb.valid[..., None], gb.albedo * full_irr, 0.0), st
