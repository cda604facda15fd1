"""DDGI probe volume (counterpart of hobbyrenderer_tpu/ops/ddgi.py).

A dense (Px, Py, Pz) grid of probes, each with an octahedral irradiance
texture (8x8x3) and a filtered-distance texture (16x16x2: E[r], E[r^2]).
An update traces N_RAYS spherical-Fibonacci rays per probe (rotated per
frame) as closest hits through the 16-wide walk (K3), shades the hits with
emission plus one NEE sample (ops/restir_gi.py) and the misses with the
sky, blends them into the textures with hysteresis, classifies probes with
many backface hits as inside geometry and relocates them. The query is the
8-probe trilinear blend with a normal weight and Chebyshev visibility."""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from hobbyrenderer_tpu_torch.ops import sky as skyops
from hobbyrenderer_tpu_torch.ops import trace as traceops
from hobbyrenderer_tpu_torch.ops.restir_gi import _hit_radiance
from hobbyrenderer_tpu_torch.ops.upsample import joint_bilateral_upsample
from hobbyrenderer_tpu_torch.scene.gpu import MATI_DOUBLE_SIDED
from hobbyrenderer_tpu_torch.utils import math as hm
from hobbyrenderer_tpu_torch.utils import tmath as tm
from hobbyrenderer_tpu_torch.utils.rng import pcg3d, uniform_from_bits

IRR_RES = 8            # octahedral irradiance texels per probe side
DIST_RES = 16          # octahedral distance texels per probe side
N_RAYS = 64            # probe rays per update
HYSTERESIS = 0.97
BACKFACE_LIMIT = 0.25  # share of backface hits above which a probe is inside
NORMAL_BIAS = 0.05     # query bias along the surface normal (x spacing norm)
QUERY_SCALE = 4        # the irradiance query's grid divisor
ENERGY = 0.95
MASK32 = 0xFFFFFFFF
PROBE_COUNTS = (8, 4, 8)   # probes along x, y, z


class DDGIVolume(NamedTuple):
    origin: torch.Tensor        # (3,) grid min corner
    spacing: torch.Tensor       # (3,) probe spacing
    counts: Tuple[int, int, int]
    irradiance: torch.Tensor    # (P, IRR, IRR, 3)
    distance: torch.Tensor      # (P, DIST, DIST, 2) mean / mean^2
    alive: torch.Tensor         # (P,) f32, 1 = usable
    offset: torch.Tensor        # (P, 3) relocation offsets
    variability: torch.Tensor   # () relative irradiance change of the last update


def _oct_texel_dirs(res: int) -> np.ndarray:
    """(res, res, 3) unit direction at each octahedral texel centre."""
    t = (np.arange(res, dtype=np.float32) + 0.5) / res * 2.0 - 1.0
    u, v = np.meshgrid(t, t, indexing="xy")
    e = np.stack([u, v], -1)
    return hm.oct_decode(e.reshape(-1, 2), xp=np).reshape(res, res, 3)


def _fibonacci_dirs(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float32) + 0.5
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    z = 1.0 - 2.0 * i / n
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([r * np.cos(phi), z, r * np.sin(phi)], -1).astype(np.float32)


def ddgi_init(scene_lo, scene_hi, device) -> DDGIVolume:
    """Fit the probe grid to the scene bounds."""
    lo = torch.as_tensor(np.asarray(scene_lo, np.float32), device=device)
    hi = torch.as_tensor(np.asarray(scene_hi, np.float32), device=device)
    c = torch.tensor(PROBE_COUNTS, dtype=torch.float32, device=device)
    P = int(np.prod(PROBE_COUNTS))
    return DDGIVolume(origin=lo, spacing=(hi - lo) / torch.clamp(c - 1.0, min=1.0),
                      counts=PROBE_COUNTS,
                      irradiance=torch.zeros((P, IRR_RES, IRR_RES, 3), device=device),
                      distance=torch.zeros((P, DIST_RES, DIST_RES, 2), device=device),
                      alive=torch.ones((P,), device=device),
                      offset=torch.zeros((P, 3), device=device),
                      variability=torch.tensor(1.0, device=device))


def probe_positions(vol: DDGIVolume) -> torch.Tensor:
    Px, Py, Pz = vol.counts
    dev = vol.origin.device
    gx, gy, gz = torch.meshgrid(torch.arange(Px, device=dev), torch.arange(Py, device=dev),
                                torch.arange(Pz, device=dev), indexing="ij")
    g = torch.stack([gx, gy, gz], -1).reshape(-1, 3).to(torch.float32)
    return vol.origin + g * vol.spacing + vol.offset


def _rand_rotation(frame: int, device) -> torch.Tensor:
    """Deterministic per-frame rotation (decorrelates the ray directions)."""
    f = frame & MASK32
    bits = pcg3d(torch.tensor([f, f ^ 0x9E3779B9, 17], dtype=torch.int64, device=device))
    a = uniform_from_bits(bits[0]) * 2 * math.pi
    b = uniform_from_bits(bits[1]) * 2 * math.pi
    ca, sa, cb, sb = torch.cos(a), torch.sin(a), torch.cos(b), torch.sin(b)
    z, o = torch.zeros_like(ca), torch.ones_like(ca)
    ry = torch.stack([torch.stack([ca, z, sa]), torch.stack([z, o, z]),
                      torch.stack([-sa, z, ca])])
    rx = torch.stack([torch.stack([o, z, z]), torch.stack([z, cb, -sb]),
                      torch.stack([z, sb, cb])])
    return ry @ rx


def ddgi_update(vol: DDGIVolume, gpu, rt, settings, frame: int,
                stats_out: dict = None) -> DDGIVolume:
    """One DDGI update: trace the probe rays, blend the octahedral textures,
    classify and relocate the probes, measure the variability.
    ``stats_out`` gets the NEE shadow rays' K3 lanes and capped lanes."""
    dev = vol.irradiance.device
    P = vol.irradiance.shape[0]
    pos = probe_positions(vol)
    dirs = torch.as_tensor(_fibonacci_dirs(N_RAYS), device=dev) @ _rand_rotation(frame, dev).T
    o = pos.repeat_interleave(N_RAYS, dim=0)                   # (P*N, 3)
    d = dirs.repeat(P, 1)
    hit = traceops.closest_hit_auto(rt, o, d)
    pix = torch.arange(o.shape[0], dtype=torch.int64, device=dev)
    _p, _n, h_rad = _hit_radiance(gpu, rt, rt.lights, hit, o, d, pix,
                                  (frame + 0xDD61) & MASK32, stats_out=stats_out)
    sun_dir = tm.normalize(torch.tensor(settings.sun_direction, dtype=torch.float32,
                                        device=dev))
    miss = hit.tri < 0
    radiance = torch.where(miss[..., None], skyops.sky_radiance(d, sun_dir, settings), h_rad)
    # backface = the wrong side of single-sided geometry only
    hmat = rt.tri_mat[rt.split_to_orig[torch.clamp(hit.tri, min=0).to(torch.int64)]]
    ds = gpu.mat_i[hmat, MATI_DOUBLE_SIDED] > 0
    backface = ~miss & ~hit.front & ~ds
    dist_raw = torch.where(miss, 1e4, hit.t)
    dist = torch.clamp(dist_raw, max=1.5 * torch.linalg.vector_norm(vol.spacing))
    radiance = radiance.reshape(P, N_RAYS, 3)
    dist = dist.reshape(P, N_RAYS)
    bf2 = backface.reshape(P, N_RAYS)
    backfrac = bf2.to(torch.float32).mean(-1)

    # irradiance blend: texel t <- sum_r w(t, r) L_r / sum_r w, w = max(cos, 0)
    tex_i = torch.as_tensor(_oct_texel_dirs(IRR_RES).reshape(-1, 3), device=dev)
    w_i = torch.clamp(torch.einsum("td,nd->tn", tex_i, dirs), min=0.0)
    irr_new = torch.einsum("tn,pnc->ptc", w_i, radiance) \
        / torch.clamp(w_i.sum(-1)[None, :, None], min=1e-6)
    # cosine-weighted mean of uniform-sphere rays -> irradiance: x pi
    irr_new = ((ENERGY * math.pi) * irr_new).reshape(P, IRR_RES, IRR_RES, 3)

    # distance blend: a sharper cosine lobe
    tex_d = torch.as_tensor(_oct_texel_dirs(DIST_RES).reshape(-1, 3), device=dev)
    w_d = torch.clamp(torch.einsum("td,nd->tn", tex_d, dirs), min=0.0) ** 8.0
    wsum = torch.clamp(w_d.sum(-1)[None, :], min=1e-6)
    dist_new = torch.stack([torch.einsum("tn,pn->pt", w_d, dist) / wsum,
                            torch.einsum("tn,pn->pt", w_d, dist * dist) / wsum],
                           -1).reshape(P, DIST_RES, DIST_RES, 2)

    h = torch.where(torch.all(vol.irradiance == 0.0), 0.0, HYSTERESIS)
    irr = vol.irradiance * h + irr_new * (1.0 - h)
    dst = vol.distance * h + dist_new * (1.0 - h)
    alive = torch.where(backfrac > BACKFACE_LIMIT, 0.0, 1.0)

    # relocation: buried probes step out through their nearest backface hit,
    # probes too close to front faces back off; applied from the next update
    dist_raw = dist_raw.reshape(P, N_RAYS)
    min_ax = torch.min(vol.spacing)
    bf_d = torch.where(bf2, dist_raw, 1e9)
    k_bf = torch.argmin(bf_d, dim=-1)
    d_bf = bf_d.gather(1, k_bf[:, None])[:, 0]
    buried = (backfrac > BACKFACE_LIMIT) & (d_bf < 1e8)
    step = torch.where(buried, d_bf + 0.2 * min_ax, 0.0)
    off = vol.offset + dirs[k_bf] * step[:, None]
    ff_d = torch.where(~bf2 & (dist_raw < 1e3), dist_raw, 1e9)
    k_ff = torch.argmin(ff_d, dim=-1)
    d_ff = ff_d.gather(1, k_ff[:, None])[:, 0]
    close = ~buried & (d_ff < 0.15 * min_ax)
    off = off - dirs[k_ff] * torch.where(close, 0.15 * min_ax - d_ff, 0.0)[:, None]
    off = torch.minimum(torch.maximum(off, -0.45 * vol.spacing), 0.45 * vol.spacing)

    varb = torch.mean(torch.abs(irr - vol.irradiance)) \
        / torch.clamp(torch.mean(torch.abs(irr)), min=1e-6)
    return vol._replace(irradiance=irr, distance=dst, alive=alive, offset=off,
                        variability=varb)


def _oct_sample(tex, pid, dirs):
    """Nearest octahedral texel of probes ``pid`` (R,) in tex (P, res, res, C)
    along dirs (R, 3) -> (R, C)."""
    res = tex.shape[1]
    e = tm.oct_encode(dirs)
    u = torch.clamp((e[..., 0] * 0.5 + 0.5) * res, 0.0, res - 1e-3)
    v = torch.clamp((e[..., 1] * 0.5 + 0.5) * res, 0.0, res - 1e-3)
    return tex.reshape(tex.shape[0], res * res, tex.shape[-1])[
        pid, v.to(torch.int64) * res + u.to(torch.int64)]


def ddgi_query(vol: DDGIVolume, pos, normal):
    """(R, 3) incident irradiance at pos / normal (R, 3): trilinear over the
    8 surrounding probes, weighted by facing and Chebyshev visibility."""
    R = pos.shape[0]
    dev = pos.device
    counts = vol.counts
    biased = pos + normal * (NORMAL_BIAS * torch.linalg.vector_norm(vol.spacing))
    g = (biased - vol.origin) / vol.spacing
    g0 = torch.floor(g).to(torch.int64)
    frac = g - g0
    acc = torch.zeros((R, 3), device=dev)
    acc_w = torch.zeros((R,), device=dev)
    for cz in range(2):
        for cy in range(2):
            for cx in range(2):
                c = (cx, cy, cz)
                gi = torch.stack([torch.clamp(g0[:, a] + c[a], 0, counts[a] - 1)
                                  for a in range(3)], -1)
                pid = (gi[:, 0] * counts[1] + gi[:, 1]) * counts[2] + gi[:, 2]
                p_pos = vol.origin + gi.to(torch.float32) * vol.spacing + vol.offset[pid]
                to_p = p_pos - biased
                d = torch.linalg.vector_norm(to_p, dim=-1)
                dir_p = to_p / torch.clamp(d, min=1e-6)[..., None]
                t = [frac[:, a] if c[a] else 1.0 - frac[:, a] for a in range(3)]
                w_tri = t[0] * t[1] * t[2]
                w_n = torch.clamp(torch.sum(dir_p * normal, -1), min=0.0) ** 2 + 0.05
                dd = _oct_sample(vol.distance, pid, -dir_p)
                mean = dd[..., 0]
                var = torch.clamp(dd[..., 1] - mean * mean, min=1e-6)
                cheb = var / (var + torch.clamp(d - mean, min=0.0) ** 2)
                vis = torch.where(d <= mean, 1.0, torch.clamp(cheb, 0.05, 1.0))
                w = w_tri * w_n * vis * vol.alive[pid]
                acc = acc + _oct_sample(vol.irradiance, pid, normal) * w[..., None]
                acc_w = acc_w + w
    return acc / torch.clamp(acc_w, min=1e-6)[..., None]


def ddgi_indirect(vol: DDGIVolume, gb, shard=None):
    """The DDGI indirect of G-buffer ``gb`` (a rank's row band under
    ``shard``, else the whole frame): the volume's irradiance queried on the
    quarter-res grid, depth/normal-guided upsampling, times albedo / pi."""
    s = QUERY_SCALE
    H, W = gb.depth.shape
    sh, sw = H // s, W // s

    def sub(img):
        return img[::s, ::s][:sh, :sw]
    E = ddgi_query(vol, sub(gb.world_pos).reshape(-1, 3),
                   sub(gb.normal).reshape(-1, 3)).reshape(sh, sw, 3)
    E = joint_bilateral_upsample(E, sub(gb.depth), sub(gb.normal), sub(gb.valid), gb.depth,
                                 gb.normal, s, shard=shard)
    return torch.where(gb.valid[..., None], (gb.albedo / math.pi) * E, 0.0)


def ddgi_probe_overlay(ldr, vol: DDGIVolume, vc, radius_px: float = 3.0):
    """The probe view: each live probe splats a dot of its mean irradiance
    (normalized to its largest channel), each dead probe a red dot; where
    dots overlap the higher probe index wins, as in the JAX package's loop
    over probes. ldr (H, W, 3) uint8 -> uint8 (the dots' colours written as
    clip(c, 0, 1) * 255 + 0.5)."""
    H, W = ldr.shape[0], ldr.shape[1]
    dev = ldr.device
    pos = probe_positions(vol)
    VP = vc["view_proj_no_jitter"]
    w = pos @ VP[3, :3] + VP[3, 3]
    clip = pos @ VP[:3, :3].T + VP[:3, 3]
    ndc = clip / torch.clamp(w, min=1e-6)[..., None]
    x = (ndc[..., 0] * 0.5 + 0.5) * W
    y = (0.5 - ndc[..., 1] * 0.5) * H
    vis = (w > 1e-6) & (x >= 0) & (x < W) & (y >= 0) & (y < H)
    color = vol.irradiance.mean((1, 2))                                  # (P, 3)
    color = color / torch.clamp(color.amax(-1, keepdim=True), min=1e-3)
    color = torch.where(vol.alive[:, None] > 0, color,
                        torch.tensor([1.0, 0.0, 0.0], device=dev))
    # the pixels (centres at integer coordinates) a dot can reach: a
    # (2r + 1)^2 window about its centre, tested with the JAX distance
    r = int(math.ceil(radius_px))
    off = torch.arange(-r, r + 1, device=dev)
    px = torch.floor(x).to(torch.int64)[:, None, None] + off[None, None, :]      # (P, 1, K)
    py = torch.floor(y).to(torch.int64)[:, None, None] + off[None, :, None]      # (P, K, 1)
    d2 = ((px.to(torch.float32) - x[:, None, None]) ** 2
          + (py.to(torch.float32) - y[:, None, None]) ** 2)
    hit = (d2 < radius_px * radius_px) & vis[:, None, None] \
        & (px >= 0) & (px < W) & (py >= 0) & (py < H)
    pid = torch.arange(pos.shape[0], device=dev)[:, None, None].expand_as(hit)
    flat = (py.clamp(0, H - 1) * W + px.clamp(0, W - 1)).expand_as(hit)
    top = torch.full((H * W,), -1, dtype=torch.int64, device=dev)
    top.scatter_reduce_(0, flat[hit], pid[hit], reduce="amax")
    top = top.reshape(H, W)
    dot = (torch.clamp(color, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    return torch.where((top >= 0)[..., None], dot[top.clamp(min=0)], ldr)
