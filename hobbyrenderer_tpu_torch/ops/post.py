"""HDR post: luminance histogram, auto-exposure, bloom (whole frame, or
banded over a rank's rows: ``bloom_sharded``), tonemap (counterpart of
hobbyrenderer_tpu/ops/post.py). A row band's histogram is summed over the
ranks by the caller (parallel/mesh.py::Mesh.psum_int)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from hobbyrenderer_tpu_torch.ops.resize import resize_bilinear
from hobbyrenderer_tpu_torch.ops.shard_utils import extend_rows
from hobbyrenderer_tpu_torch.utils import tmath as tm

HIST_BINS = 256
LOG_LUM_MIN = -10.0
LOG_LUM_MAX = 20.0
HIST_STRIDE = 2
BLOOM_MIPS = 6


def luminance_histogram(hdr):
    """256-bin log2-luminance histogram over every HIST_STRIDE-th pixel."""
    if hdr.ndim == 3:
        hdr = hdr[::HIST_STRIDE, ::HIST_STRIDE]
    lum = tm.luminance(hdr)
    loglum = torch.log2(torch.clamp(lum, min=1e-12))
    t = (loglum - LOG_LUM_MIN) / (LOG_LUM_MAX - LOG_LUM_MIN)
    bins = torch.clamp((t * (HIST_BINS - 2)).to(torch.int64) + 1, 1, HIST_BINS - 1)
    bins = torch.where(lum < 1e-6, 0, bins)
    return torch.bincount(bins.reshape(-1), minlength=HIST_BINS).to(torch.float32)


def exposure_adapt(hist, prev_exposure, dt: float, settings):
    """Histogram-weighted mean log-luminance -> EV100 target -> exponential
    adaptation. Returns the new exposure as a 0-d f32 tensor."""
    w = torch.cat([torch.zeros_like(hist[:1]), hist[1:]])
    total = torch.clamp(torch.sum(w), min=1.0)
    centers = (torch.arange(HIST_BINS, dtype=torch.float32, device=hist.device) - 1.0) \
        / (HIST_BINS - 2)
    avg_log = torch.sum(w * (centers * (LOG_LUM_MAX - LOG_LUM_MIN) + LOG_LUM_MIN)) / total
    ev100 = torch.log2(torch.exp2(avg_log) * 100.0 / 12.5)
    ev100 = torch.clamp(ev100 - settings.exposure_compensation, -6.0, 17.0)
    target = 1.0 / (1.2 * torch.exp2(ev100))
    a = 1.0 - math.exp(-dt * settings.adaptation_speed)
    return (prev_exposure + (target - prev_exposure) * a).to(torch.float32)


def downsample2(x):
    """(H, W, C) 2x2 box average (odd trailing row/col dropped)."""
    return F.avg_pool2d(x.permute(2, 0, 1)[None], 2, 2)[0].permute(1, 2, 0)


def _bloom_prefilter(hdr, settings):
    thr = settings.bloom_threshold
    knee = max(settings.bloom_knee * thr, 1e-4)
    lum = tm.luminance(hdr)[..., None]
    soft = torch.clamp(lum - thr + knee, 0.0, 2.0 * knee)
    soft = soft * soft / (4.0 * knee)
    weight = torch.maximum(lum - thr, soft) / torch.clamp(lum, min=1e-4)
    return hdr * weight


def bloom(hdr, settings):
    """Dual-pyramid bloom: knee prefilter, 6-mip downsample chain, radius-
    weighted upsample accumulation, additive composite."""
    pre = _bloom_prefilter(hdr, settings)
    chain = [pre]
    x = pre
    for _ in range(BLOOM_MIPS):
        h, w = x.shape[0], x.shape[1]
        if h < 4 or w < 4:
            break
        if h % 2 or w % 2:
            x = F.pad(x.permute(2, 0, 1)[None], (0, w % 2, 0, h % 2),
                      mode="replicate")[0].permute(1, 2, 0)
        x = downsample2(x)
        chain.append(x)
    acc = chain[-1]
    for lvl in range(len(chain) - 2, -1, -1):
        up = resize_bilinear(acc, chain[lvl].shape[0], chain[lvl].shape[1])
        acc = chain[lvl] + up * settings.bloom_radius
    return hdr + acc * settings.bloom_intensity


def bloom_sharded(hdr, settings, shard, full_h: int):
    """bloom() on a rank's row band (``shard``): the downsample chain and
    the upsample accumulation run on the band, one halo row a level crossing
    to each neighbour. The chain goes down while a level's 2x2 blocks nest
    inside the band (its band height even) and bloom()'s own stop (height
    and width >= 4) holds for the whole frame, as the JAX package's
    bloom_sharded does: at a band height with fewer factors of 2 than
    bloom() takes levels (544 rows = 32 * 17 at 1088 on 2 ranks) the
    pyramid stops that many levels short of bloom(). The 2x bilinear
    upsample of a band is the half-pixel kernel out[2i] = 0.25 in[i-1] +
    0.75 in[i], out[2i+1] = 0.75 in[i] + 0.25 in[i+1], with in[] clamped at
    the frame's edges (where extend_rows leaves zeros)."""
    h_band, W = hdr.shape[0], hdr.shape[1]
    lvl_band, hb, hg, wg = 0, h_band, full_h, W
    while lvl_band < BLOOM_MIPS and hb % 2 == 0 and hg >= 4 and wg >= 4:
        lvl_band, hb = lvl_band + 1, hb // 2
        hg, wg = (hg + hg % 2) // 2, (wg + wg % 2) // 2
    is_top = shard.y0 == 0
    is_bot = shard.y0 + h_band == full_h

    chain = [_bloom_prefilter(hdr, settings)]
    x = chain[0]
    for _ in range(lvl_band):
        if x.shape[1] % 2:
            x = torch.cat([x, x[:, -1:]], 1)
        x = downsample2(x)
        chain.append(x)

    def up2_rows(xb, out_w):
        ext = extend_rows(xb, 1, shard)
        top = xb[:1] if is_top else ext[:1]
        bot = xb[-1:] if is_bot else ext[-1:]
        a = torch.cat([top, ext[1:-2]], 0)
        b = ext[1:-1]
        c = torch.cat([ext[2:-1], bot], 0)
        h2 = xb.shape[0] * 2
        rows = torch.stack([0.25 * a + 0.75 * b, 0.75 * b + 0.25 * c], 1).reshape(
            h2, *xb.shape[1:])
        ew = torch.cat([rows[:, :1], rows, rows[:, -1:]], 1)
        aw, bw, cw = ew[:, :-2], ew[:, 1:-1], ew[:, 2:]
        cols = torch.stack([0.25 * aw + 0.75 * bw, 0.75 * bw + 0.25 * cw], 2).reshape(
            h2, rows.shape[1] * 2, *xb.shape[2:])
        return cols[:, :out_w]

    acc = chain[-1]
    for lvl in range(len(chain) - 2, -1, -1):
        acc = chain[lvl] + up2_rows(acc, chain[lvl].shape[1]) * settings.bloom_radius
    return hdr + acc * settings.bloom_intensity


def tonemap_pbr_neutral(c):
    """Khronos PBR Neutral tonemapper."""
    start_compression = 0.8 - 0.04
    desaturation = 0.15
    x = torch.minimum(c[..., 0], torch.minimum(c[..., 1], c[..., 2]))
    offset = torch.where(x < 0.08, x - 6.25 * x * x, 0.04)
    c = c - offset[..., None]
    peak = torch.maximum(c[..., 0], torch.maximum(c[..., 1], c[..., 2]))
    d = 1.0 - start_compression
    new_peak = 1.0 - d * d / (peak + d - start_compression)
    scale = torch.where(peak < start_compression, 1.0,
                        new_peak / torch.clamp(peak, min=1e-6))
    c_comp = c * scale[..., None]
    g = torch.where(peak < start_compression, 0.0,
                    1.0 - 1.0 / (desaturation * (peak - new_peak) + 1.0))
    return torch.clamp(c_comp * (1.0 - g[..., None]) + new_peak[..., None] * g[..., None],
                       0.0, 1.0)


def srgb_oetf(c):
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, 12.92 * c, 1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)


def tonemap_to_output(hdr, exposure):
    """Exposure -> PBR Neutral -> sRGB -> uint8."""
    ldr = srgb_oetf(tonemap_pbr_neutral(hdr * exposure))
    return (torch.clamp(ldr, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
