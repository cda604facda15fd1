"""ReSTIR DI: reservoir-based spatiotemporal importance resampling for
direct lighting over the polymorphic light pool (counterpart of
hobbyrenderer_tpu/ops/restir.py).

Per frame: candidates from power-presampled light tiles or ReGIR cells
(ops/regir.py) through kernel K2 (ops/restir_kernel.py) -> temporal reuse
(nearest-texel reprojection) -> boiling filter -> spatial reuse with
frame-wide tap offsets -> finalize -> shade the winner with one visibility
ray. Winner visibility follows the JAX package's TPU branch on every
device: two tile-modal any-hit passes (K4, ops/beam.py) and the remaining
"straggler" lanes compacted to a fixed capacity and walked by K3
(ops/bvh16.py); the reduced-rate path traces the
(::vs, ::vs) subgrid and re-traces mismatched winners through K3.

No step of the chain reads a device value back to the host: compactions
keep a fixed capacity (cumsum + scatter), the frame index and the spatial
tap offsets are host numbers, and the overflow counts stay device tensors.
On a rank's row band (``shard``, ops/shard_utils) every RNG key is the
global pixel id, K2 takes the band's first row, the temporal and spatial
taps and the boiling filter's window reach the neighbouring bands through
halo rows, and the visibility capacities are the band's own (as the JAX
package computes them)."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from hobbyrenderer_tpu_torch.ops import beam as beamops
from hobbyrenderer_tpu_torch.ops import bvh16 as b16ops
from hobbyrenderer_tpu_torch.ops import lights as lightops
from hobbyrenderer_tpu_torch.ops import regir as regirops
from hobbyrenderer_tpu_torch.ops import restir_kernel as rkops
from hobbyrenderer_tpu_torch.ops import sampling as smp
from hobbyrenderer_tpu_torch.ops import shading as shadeops
from hobbyrenderer_tpu_torch.ops.intersect import retarget_shadow_ray
from hobbyrenderer_tpu_torch.ops.shard_utils import extend_rows, full_height, global_y0
from hobbyrenderer_tpu_torch.ops.warp import pad_edges, warp_image
from hobbyrenderer_tpu_torch.scene.scene import LIGHT_DIRECTIONAL
from hobbyrenderer_tpu_torch.utils import tmath as tm
from hobbyrenderer_tpu_torch.utils.rng import pcg3d, uniform_from_bits

M_CLAMP_TEMPORAL = 20.0     # temporal M clamp
VIS_SCALE_MIN_DIM = 512     # reduced-rate visibility only at real resolutions
SPATIAL_RADIUS = 30.0       # px
SPATIAL_TAPS = 4
HALO = 32                   # edge pad >= SPATIAL_RADIUS
# straggler and mismatch walk budget in K3 steps (the XLA bvh16 branch,
# restir.py:194-196)
STRAGGLER_STEPS = 64


class Reservoir(NamedTuple):
    """Per-pixel light reservoir; across frames only these persist."""

    y: torch.Tensor       # (H, W) int64 selected pool light id (-1 = empty)
    uv: torch.Tensor      # (H, W, 2) f32 area-light sample point
    w_sum: torch.Tensor   # (H, W) f32 sum of RIS weights
    M: torch.Tensor       # (H, W) f32 candidate count
    W: torch.Tensor       # (H, W) f32 unbiased contribution weight


def reservoir_init(h: int, w: int, device) -> Reservoir:
    return Reservoir(y=torch.full((h, w), -1, dtype=torch.int64, device=device),
                     uv=torch.zeros((h, w, 2), device=device),
                     w_sum=torch.zeros((h, w), device=device),
                     M=torch.zeros((h, w), device=device),
                     W=torch.zeros((h, w), device=device))


def _rand(pix, frame: int, dim: int):
    bits = pcg3d(torch.stack([pix, torch.full_like(pix, frame),
                              torch.full_like(pix, dim)], -1))
    return (uniform_from_bits(bits[..., 0]), uniform_from_bits(bits[..., 1]),
            uniform_from_bits(bits[..., 2]))


def _fallback_pool(gpu) -> lightops.LightPool:
    """Analytic-only pool (no emissive triangles, uniform power)."""
    A = gpu.light_type.shape[0]
    dev = gpu.device
    p = (torch.arange(A, device=dev) < gpu.meta["light_count"]).to(torch.float32)
    p = p / torch.clamp(p.sum(), min=1e-20)
    pdf = torch.cat([p, torch.zeros(1, device=dev)])
    z3 = torch.zeros((1, 3), device=dev)
    pool = lightops.LightPool(
        n_analytic=A, n_total=A, em_v0=z3, em_e1=z3, em_e2=z3, em_rad=z3,
        em_orig=torch.full((1,), -1, dtype=torch.int64, device=dev),
        em_scale=torch.ones(1, device=dev), power_cdf=torch.cumsum(pdf, 0),
        power_pdf=pdf, packed=None)
    return lightops.pack_pool(pool, gpu)


def _box_sum(x, r: int):
    """Zero-padded (2r+1)^2 box sum of (H, W) by cumulative sums (float64,
    so the result does not depend on the summation order)."""
    H, W = x.shape
    c = F.pad(torch.cumsum(torch.cumsum(x.to(torch.float64), 0), 1), (1, 0, 1, 0))
    ys = torch.arange(H, device=x.device)
    xs = torch.arange(W, device=x.device)
    y1, y0 = torch.clamp(ys + r + 1, max=H), torch.clamp(ys - r, min=0)
    x1, x0 = torch.clamp(xs + r + 1, max=W), torch.clamp(xs - r, min=0)
    s = (c[y1][:, x1] - c[y0][:, x1] - c[y1][:, x0] + c[y0][:, x0])
    return s.to(torch.float32)


def boiling_filter_mask(w_sum_2d, live_2d, mult: float = 20.0, radius: int = 16,
                        shard=None):
    """Boiling-filter kill mask: live reservoirs whose weight exceeds
    ``mult`` times the (2r+1)^2 windowed mean of live weights (rows and
    columns outside the frame count zero weight and zero count). On a row
    band the window's rows past the band come from the neighbours."""
    w = torch.where(live_2d, w_sum_2d, 0.0)
    cnt = live_2d.to(torch.float32)
    if shard is None or shard.n == 1:
        mean = _box_sum(w, radius) / torch.clamp(_box_sum(cnt, radius), min=1.0)
    else:
        H, r = w.shape[0], radius
        ext = extend_rows(torch.stack([w, cnt], -1), r, shard)
        gy = torch.arange(-r, H + r, device=w.device) + shard.y0
        ext = ext * ((gy >= 0) & (gy < shard.full_h)).to(torch.float32)[:, None, None]
        mean = (_box_sum(ext[..., 0], r)[r:r + H]
                / torch.clamp(_box_sum(ext[..., 1], r)[r:r + H], min=1.0))
    return live_2d & (w_sum_2d > mult * torch.clamp(mean, min=1e-20))


def _compact(mask, cap: int):
    """Fixed-capacity compaction: (sel (cap,) lane ids, R = padding; rank)."""
    R = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    slot = torch.where(mask & (rank < cap), rank, cap)
    sel = torch.full((cap + 1,), R, dtype=torch.int64, device=mask.device)
    sel.scatter_(0, slot, torch.arange(R, dtype=torch.int64, device=mask.device))
    return sel[:cap], rank


def _scatter_back(sel, vals, R: int):
    """(cap,) bool values at lane ids sel (R = padding, dropped) -> (R,)."""
    out = torch.zeros(R + 1, dtype=torch.bool, device=sel.device)
    out.scatter_(0, sel, vals)
    return out[:R]


def _add_stat(stats_out, key, value):
    if stats_out is not None:
        stats_out[key] = stats_out[key] + value if key in stats_out else value


def _trace_compacted(rt, mask, o, L_vis, tmax, cap: int, steps, stats_out: dict):
    """Occlusion (R,) bool of the lanes in ``mask``: they compact to ``cap``
    lanes for one K3 any-hit walk of ``steps`` (None: the uncapped budget).
    Lanes past the cap are never traced and count as occluded (a brief
    over-dark shadow rather than a light leak that temporal reuse would
    amplify), and are reported as overflow."""
    R = mask.shape[0]
    sel, rank = _compact(mask, cap)
    pad = sel >= R
    selc = torch.clamp(sel, max=R - 1)
    o_c = torch.where(pad[:, None], 0.0, o[selc])
    d_c = torch.where(pad[:, None], 0.0, L_vis[selc])
    tm_c = torch.where(pad, 0.0, tmax[selc])
    occ_c, capped = b16ops.bvh16_any_hit(rt.bvh16, o_c, d_c, t_max=tm_c, max_steps=steps,
                                          return_capped=True)
    _add_stat(stats_out, "overflow", torch.clamp(mask.sum() - cap, min=0))
    _add_stat(stats_out, "k3_lanes", (~pad).sum())
    _add_stat(stats_out, "k3_capped", (capped & ~pad).sum())
    return torch.where(mask & (rank >= cap), True, _scatter_back(sel, occ_c & ~pad, R))


def _winner_occlusion(rt, o, L_vis, tmax, shoot, y_ids, H: int, W: int,
                      stats_out: dict, straggler_steps: int = STRAGGLER_STEPS):
    """One occlusion bit per lane for the winner rays (R = H*W lanes): the
    top-two tile-modal winners each ride a K4 pass, the stragglers compact
    to CAP = max(R//32, 1024) lanes for a K3 walk of ``straggler_steps``;
    lanes past CAP count as occluded. ``straggler_steps=None`` traces every
    straggler with the uncapped budget."""
    R = H * W
    shoot2 = shoot.reshape(H, W)
    o2, Lv2, tm2 = o.reshape(H, W, 3), L_vis.reshape(H, W, 3), tmax.reshape(H, W)
    key = torch.where(shoot2, y_ids.reshape(H, W), -1)
    match = beamops.tile_majority_mask(key, H, W, exclude=-1) & shoot2
    occ_b, n_ovf = beamops.beam_any_hit(rt.btable, o2, Lv2, tm2, match, H, W)
    key2 = torch.where(match, -1, key)
    match2 = beamops.tile_majority_mask(key2, H, W, exclude=-1) & shoot2 & ~match
    occ_b2, n_ovf2 = beamops.beam_any_hit(rt.btable, o2, Lv2, tm2, match2, H, W)
    occ_b = torch.where(match2, occ_b2, occ_b)
    match = (match | match2).reshape(R)
    minority = shoot & ~match
    _add_stat(stats_out, "overflow", n_ovf + n_ovf2)
    CAP = R if straggler_steps is None else max(R // 32, 1024)
    occ_m = _trace_compacted(rt, minority, o, L_vis, tmax, CAP, straggler_steps, stats_out)
    return torch.where(match, occ_b.reshape(R), occ_m)


def _tap_offsets(spatial_taps: int, frame: int, salt: int = 0x5EED,
                 radius: float = SPATIAL_RADIUS):
    """Frame-wide spatial tap offsets (dx, dy) as host ints: counter RNG on
    the CPU, one offset per tap (the same draws as the JAX package's device
    scalars; ReSTIR GI passes its own salt and radius)."""
    out = []
    for k in range(spatial_taps):
        kb = pcg3d(torch.tensor([[k + 1, frame, salt]], dtype=torch.int64))[0]
        u_a, u_b = uniform_from_bits(kb[0]), uniform_from_bits(kb[1])
        ang = u_a * (2 * math.pi)
        rad_px = 1.0 + torch.sqrt(u_b) * (radius - 1.0)
        out.append((int(torch.round(torch.cos(ang) * rad_px)),
                    int(torch.round(torch.sin(ang) * rad_px))))
    return out


def restir_di(gpu, rt, gb, vc, settings, prev: Reservoir, frame_index: int,
              num_candidates: int = 8, visibility: bool = True,
              spatial_taps: int = SPATIAL_TAPS, boiling_mult: float = 20.0,
              regir_grid=None, stats_out: dict = None, checkerboard: bool = False,
              vis_scale: int = 1, vis_scale_min_dim: int = VIS_SCALE_MIN_DIM,
              straggler_steps: int = STRAGGLER_STEPS, shard=None):
    """Full ReSTIR DI chain for one frame. gb: GBuffer; prev: last frame's
    reservoir; the light pool is rt.lights, else an analytic-only pool.

    The reference's two module globals are arguments here:
    ``vis_scale_min_dim``, below which reduced-rate visibility falls back to
    full rate, and ``straggler_steps``, the K3 budget of the straggler walk
    and of the mismatch re-trace (the reference's are both 64 K3 steps:
    restir.py:194-196, and any_hit_auto's max_steps=256 at trace.py:498).
    ``straggler_steps=None`` traces winner visibility exactly: every
    straggler and mismatch lane, uncapped, instead of the reference's fixed
    capacities (which bind at thumbnail sizes).
    ``regir_grid`` (an ops/regir.RegirGrid) replaces the presample tiles:
    each 128-pixel segment reads the cell that covers its centre pixel, and
    slot 16 carries the cell reservoir's W in place of 1/power_pdf.
    ``shard``: gb and prev are a rank's row band (ops/shard_utils).
    Returns (direct (H, W, 3), Reservoir)."""
    H, W = gb.depth.shape
    R = H * W
    dev = gb.depth.device
    frame = int(frame_index)
    y0 = global_y0(shard)
    full_h = full_height(shard, H)
    # RNG key: the global pixel id gy * W + x
    pix = torch.arange(R, dtype=torch.int64, device=dev) + y0 * W
    pool = getattr(rt, "lights", None)
    if pool is None:
        pool = _fallback_pool(gpu)

    pos = gb.world_pos.reshape(R, 3)
    n = gb.normal.reshape(R, 3)
    valid = gb.valid.reshape(R)
    cam = vc["camera_pos"]
    v = tm.normalize(cam[None, :] - pos)
    albedo = gb.albedo.reshape(R, 3)
    rough = gb.orm.reshape(R, 3)[:, 1]
    metal = gb.orm.reshape(R, 3)[:, 2]

    def p_hat_rows(rows, li, uv):
        """Target: luminance of the unshadowed reflected radiance of the
        sample described by in-hand packed rows."""
        L, rad, dist = lightops.light_incident_rows(rows, uv, pos)
        f = shadeops.eval_brdf(n, v, L, albedo, metal, rough)
        return torch.where(valid & (li >= 0), tm.luminance(f * rad), 0.0), L, dist

    def res_update(state, cand_y, cand_uv, cand_row, cand_w, u):
        y, uv, row, w_sum = state
        w_sum_new = w_sum + cand_w
        take = (u * torch.clamp(w_sum_new, min=1e-20)) < cand_w
        return (torch.where(take, cand_y, y), torch.where(take[..., None], cand_uv, uv),
                torch.where(take[..., None], cand_row, row), w_sum_new)

    # ---- checkerboard half grid ----
    if checkerboard:
        if W % 2:
            raise ValueError("checkerboard needs an even render width")
        Wc = W // 2
        par = (torch.arange(H, device=dev) + y0 + frame) & 1     # (H,) global rows

        def _half(img):
            pr = par.reshape((H,) + (1,) * (img.ndim - 1))
            return torch.where(pr == 0, img[:, 0::2][:, :Wc], img[:, 1::2][:, :Wc])

        pos_g, n_g, alb_g, orm_g, valid_g = (_half(gb.world_pos), _half(gb.normal),
                                             _half(gb.albedo), _half(gb.orm),
                                             _half(gb.valid))
    else:
        Wc = W
        pos_g, n_g, alb_g, orm_g, valid_g = (gb.world_pos, gb.normal, gb.albedo,
                                             gb.orm, gb.valid)
    Rc = H * Wc

    # ---- presampled candidate tiles (or ReGIR cells) + initial candidates (K2) ----
    if regir_grid is not None:
        tile_rows = regir_grid.rows                               # (C, 128, 18)
    else:
        tile_rows = lightops.presample_light_rows(pool, frame)    # (T, 128, 18)
    T, S, _ = tile_rows.shape
    nseg = (Wc + S - 1) // S
    Wp = nseg * S
    Hp = -(-H // rkops.ROWS) * rkops.ROWS
    if regir_grid is not None:
        seg_x = torch.clamp(torch.arange(nseg, device=dev) * S + S // 2, max=Wc - 1)
        tsel = regirops.cells_of_positions(regir_grid, pos_g[:, seg_x], valid_g[:, seg_x])
    else:
        gy_img = torch.arange(H, dtype=torch.int64, device=dev) + y0
        seg = torch.arange(nseg, dtype=torch.int64, device=dev)
        sbits = pcg3d(torch.stack([gy_img[:, None].expand(H, nseg),
                                   seg[None, :].expand(H, nseg),
                                   torch.full((H, nseg), frame, dtype=torch.int64,
                                              device=dev)], -1))
        tsel = (sbits[..., 0] % T).to(torch.int32)
    planes = torch.cat([pos_g.permute(2, 0, 1), n_g.permute(2, 0, 1),
                        alb_g.permute(2, 0, 1), orm_g[..., 1][None], orm_g[..., 2][None],
                        valid_g.to(torch.float32)[None]], 0)
    planes = F.pad(planes, (0, Wp - Wc, 0, Hp - H)).contiguous()
    tselp = F.pad(tsel, (0, 0, 0, Hp - H)).contiguous()
    yf, uf, vf, wf, rowf = rkops.restir_candidates(
        tile_rows.permute(0, 2, 1).contiguous(), tselp, planes, cam.contiguous(), frame, y0,
        num_candidates=num_candidates, w_log=W)
    y = torch.round(yf[:H, :Wc]).to(torch.int64).reshape(Rc)
    uv = torch.stack([uf[:H, :Wc].reshape(Rc), vf[:H, :Wc].reshape(Rc)], -1)
    w_sum = wf[:H, :Wc].reshape(Rc)
    row = rowf[:H, :, :Wc].permute(0, 2, 1).reshape(Rc, 16)
    M = torch.full((Rc,), float(num_candidates), device=dev)

    if checkerboard:
        # off-parity pixels start EMPTY and are refilled by temporal reuse
        def _expand(cmp, fill):
            img = cmp.reshape((H, Wc) + cmp.shape[1:])
            pr = par.reshape((H,) + (1,) * (img.ndim - 1))
            f = torch.full_like(img, fill)
            return torch.stack([torch.where(pr == 0, img, f), torch.where(pr == 1, img, f)],
                               2).reshape((R,) + cmp.shape[1:])

        y, uv, row = _expand(y, -1), _expand(uv, 0.0), _expand(row, 0.0)
        w_sum, M = _expand(w_sum, 0.0), _expand(M, 0.0)

    # ---- temporal reuse (nearest-texel reprojection) ----
    motion = gb.motion
    xs = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    ys = torch.arange(H, dtype=torch.float32, device=dev) + y0 + 0.5
    prev_x = xs[None, :] + motion[..., 0]
    prev_y = ys[:, None] + motion[..., 1]
    on_screen = ((prev_x >= 0) & (prev_x < W) & (prev_y >= 0)
                 & (prev_y < full_h)).reshape(R)
    packed = torch.cat([prev.y.to(torch.float32)[..., None], prev.uv, prev.M[..., None],
                        prev.W[..., None]], -1)
    pw = warp_image(packed, motion, halo=HALO, bilinear=False, shard=shard)
    ty = torch.round(pw[..., 0]).to(torch.int64).reshape(R)
    tuv = pw[..., 1:3].reshape(R, 2)
    tM = torch.clamp(pw[..., 3].reshape(R), max=M_CLAMP_TEMPORAL)
    tW = pw[..., 4].reshape(R)
    t_ok = on_screen & (ty >= 0)
    Np = pool.packed.shape[0]
    trow = pool.packed[torch.clamp(ty, 0, Np - 1)]     # the one pool gather
    ph_t, _, _ = p_hat_rows(trow, torch.where(t_ok, ty, -1), tuv)
    w_t = torch.where(t_ok, ph_t * tW * tM, 0.0)
    u1, _, _ = _rand(pix, frame, 200)
    y, uv, row, w_sum = res_update((y, uv, row, w_sum), ty, tuv, trow, w_t, u1)
    M = M + torch.where(t_ok, tM, 0.0)

    # ---- boiling filter ----
    if boiling_mult > 0.0:
        kill = boiling_filter_mask(w_sum.reshape(H, W), (y >= 0).reshape(H, W),
                                   mult=boiling_mult, shard=shard).reshape(R)
        y = torch.where(kill, -1, y)
        w_sum = torch.where(kill, 0.0, w_sum)

    # ---- spatial reuse: merge K neighbours at frame-wide offsets ----
    ph_s, _, _ = p_hat_rows(row, y, uv)
    W_snap = torch.where((y >= 0) & (ph_s > 0), w_sum / torch.clamp(M * ph_s, min=1e-20),
                         0.0)
    snap = torch.cat([y.reshape(H, W).to(torch.float32)[..., None], uv.reshape(H, W, 2),
                      W_snap.reshape(H, W)[..., None], M.reshape(H, W)[..., None],
                      gb.normal, gb.depth[..., None], gb.valid.to(torch.float32)[..., None],
                      row.reshape(H, W, 16)], -1)
    snap_e = pad_edges(snap, HALO, shard)
    d_c = gb.depth.reshape(R)
    for k, (dx, dy) in enumerate(_tap_offsets(spatial_taps, frame)):
        nb = snap_e[HALO + dy:HALO + dy + H, HALO + dx:HALO + dx + W]
        yy = torch.round(nb[..., 0]).to(torch.int64).reshape(R)
        yuv = nb[..., 1:3].reshape(R, 2)
        W_n = nb[..., 3].reshape(R)
        mm = nb[..., 4].reshape(R)
        n_n = nb[..., 5:8].reshape(R, 3)
        d_n = nb[..., 8].reshape(R)
        val_n = nb[..., 9].reshape(R) > 0.5
        yrow = nb[..., 10:26].reshape(R, 16)
        # neighbour similarity (depth + normal) guards against bias at edges
        similar = ((torch.sum(n_n * n, -1) > 0.9)
                   & (torch.abs(d_n - d_c) < 0.1 * torch.clamp(d_c, min=1e-3))
                   & valid & val_n)
        _, _, u_c = _rand(pix, frame, 300 + k)
        ph_here, _, _ = p_hat_rows(yrow, torch.where(similar, yy, -1), yuv)
        use = similar & (yy >= 0)
        w_n = torch.where(use, ph_here * W_n * mm, 0.0)
        y, uv, row, w_sum = res_update((y, uv, row, w_sum), yy, yuv, yrow, w_n, u_c)
        M = M + torch.where(use, mm, 0.0)

    # ---- finalize W ----
    ph_y, L_y, _ = p_hat_rows(row, y, uv)
    Wgt = torch.where((y >= 0) & (ph_y > 0), w_sum / torch.clamp(M * ph_y, min=1e-20), 0.0)

    # ---- shade the winner with one visibility ray ----
    is_sun = ((y >= 0) & (row[:, 13] < 0.5)
              & (torch.round(row[:, 0]).to(torch.int64) == LIGHT_DIRECTIONAL))
    u_s1, u_s2, _ = _rand(pix, frame, 400)
    cos_max = float(np.cos(np.float32(settings.sun_angular_radius)))
    L_final = torch.where(is_sun[..., None], smp.sample_cone(L_y, cos_max, u_s1, u_s2), L_y)
    _, rad, dist = lightops.light_incident_rows(row, uv, pos)
    f = shadeops.eval_brdf(n, v, L_final, albedo, metal, rough)
    contrib = f * rad * Wgt[..., None]
    if stats_out is not None:
        stats_out["overflow"] = torch.zeros((), dtype=torch.int64, device=dev)
        stats_out["k3_lanes"] = torch.zeros((), dtype=torch.int64, device=dev)
        stats_out["k3_capped"] = torch.zeros((), dtype=torch.int64, device=dev)
    if visibility and rt is not None:
        gn = gb.geo_normal.reshape(R, 3)
        bias = settings.shadow_bias
        o = pos + gn * bias + L_final * bias
        shoot = valid & (y >= 0) & (Wgt > 0)
        L_vis, tmax_t = retarget_shadow_ray(pos, o, L_final, dist)
        tmax = torch.where(shoot, tmax_t, 1e-4)
        vs = max(int(vis_scale), 1)
        if vs > 1 and min(full_h, W) < vis_scale_min_dim:
            vs = 1      # the reuse offset is a large image fraction at thumbnails
        if vs > 1:
            # reduced-rate winner visibility: trace the (::vs, ::vs) subgrid;
            # a lane whose winner matches its quad's traced lane reuses that
            # bit, mismatched lanes re-trace exactly through K3
            Hh, Wh = -(-H // vs), -(-W // vs)

            def sub2(a):
                return a.reshape((H, W) + a.shape[1:])[::vs, ::vs]

            def up2(a):
                return torch.repeat_interleave(torch.repeat_interleave(a, vs, 0), vs, 1)[:H, :W]

            sh_h = sub2(shoot).reshape(-1)
            y_h = sub2(y)
            occ_h = _winner_occlusion(rt, sub2(o).reshape(-1, 3), sub2(L_vis).reshape(-1, 3),
                                      sub2(tmax).reshape(-1), sh_h, y_h.reshape(-1), Hh, Wh,
                                      stats_out, straggler_steps)
            occ_e = up2(occ_h.reshape(Hh, Wh)).reshape(R)
            same = shoot & up2(sh_h.reshape(Hh, Wh)).reshape(R) & (y == up2(y_h).reshape(R))
            mismatch = shoot & ~same
            CAPm = R if straggler_steps is None else max(R // 64, 1024)
            occ_m = _trace_compacted(rt, mismatch, o, L_vis, tmax, CAPm, straggler_steps,
                                     stats_out)
            occ = torch.where(same, occ_e, occ_m)
        else:
            occ = _winner_occlusion(rt, o, L_vis, tmax, shoot, y, H, W, stats_out,
                                    straggler_steps)
        contrib = torch.where(occ[..., None], 0.0, contrib)
    contrib = torch.where((valid & (y >= 0))[..., None], contrib, 0.0)

    new_res = Reservoir(y=y.reshape(H, W), uv=uv.reshape(H, W, 2), w_sum=w_sum.reshape(H, W),
                        M=M.reshape(H, W), W=Wgt.reshape(H, W))
    return contrib.reshape(H, W, 3), new_res
