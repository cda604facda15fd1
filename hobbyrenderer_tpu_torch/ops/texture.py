"""Material texture sampling (stochastic trilinear) from the packed texel
table or through the streaming residency tables, the streaming feedback
histogram, uv LOD and normal mapping.

Counterpart of hobbyrenderer_tpu/ops/texture.py. Texel rows are int64
tensors holding the packed uint32 words (scene/textures.py layout)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from hobbyrenderer_tpu_torch.utils import tmath as tm
from hobbyrenderer_tpu_torch.utils.rng import uniform_from_bits


class TexSample(NamedTuple):
    albedo: torch.Tensor
    alpha: torch.Tensor
    normal_ts: torch.Tensor
    occlusion: torch.Tensor
    roughness: torch.Tensor
    metallic: torch.Tensor
    emissive: torch.Tensor


def _srgb_to_linear(c):
    return torch.pow(c, 2.2)


def sample_material(gpu, tex_size, tex_base, uv, lod, rng_key3) -> TexSample:
    """One jittered nearest fetch per sample whose expectation is the
    trilinear result (see the JAX version)."""
    u0 = uniform_from_bits(rng_key3[..., 0])
    u1 = uniform_from_bits(rng_key3[..., 1])
    u2 = uniform_from_bits(rng_key3[..., 2])
    S = torch.clamp(tex_size.to(torch.int64), min=1)
    max_l = torch.round(torch.log2(S.to(torch.float32))).to(torch.int64)
    l = torch.minimum(torch.clamp(torch.floor(lod + u0).to(torch.int64), min=0), max_l)
    Sl = torch.clamp(S >> l, min=1)
    Slf = Sl.to(torch.float32)
    off = tex_base + (4 * S * S - 4 * Sl * Sl) // 3
    tx = uv[..., 0] * Slf - 0.5 + u1
    ty = uv[..., 1] * Slf - 0.5 + u2
    xi = torch.floor(tx).to(torch.int64) % Sl
    yi = torch.floor(ty).to(torch.int64) % Sl
    idx = off + yi * Sl + xi
    rows = gpu.tex_table[torch.clamp(idx, 0, gpu.tex_table.shape[0] - 1)]
    return _decode_rows(rows)


def _decode_rows(rows) -> TexSample:
    def u8(word, byte):
        return ((rows[..., word] >> (8 * byte)) & 0xFF).to(torch.float32) / 255.0

    base = torch.stack([u8(0, 0), u8(0, 1), u8(0, 2)], -1)
    nrm_xy = torch.stack([u8(1, 0), u8(1, 1)], -1) * 2.0 - 1.0
    nz = torch.sqrt(torch.clamp(1.0 - torch.sum(nrm_xy * nrm_xy, -1), min=0.04))
    emis = torch.stack([u8(2, 1), u8(2, 2), u8(2, 3)], -1)
    return TexSample(albedo=_srgb_to_linear(base), alpha=u8(0, 3),
                     normal_ts=torch.cat([nrm_xy, nz[..., None]], -1),
                     occlusion=u8(1, 2), roughness=u8(1, 3), metallic=u8(2, 0),
                     emissive=_srgb_to_linear(emis))


def sample_material_streamed(stream, mat, uv, lod, rng_key3) -> TexSample:
    """Stochastic-trilinear sample through the streaming tables
    (scene/streaming.py StreamTables): the requested lod is clamped to the
    material's finest fully-resident mip; tail mips (<= 32x32) read dense
    rows at the pool head, streamed mips go through the page table. One
    texel-row gather, as the dense path, plus three small-table gathers."""
    from hobbyrenderer_tpu_torch.scene.streaming import PAGE_TEXELS, TAIL_MAX, TILE
    MIPS = stream.vt_base.shape[1]
    M = stream.mat_resident.shape[0]
    mc = torch.clamp(mat, 0, M - 1)
    u0 = uniform_from_bits(rng_key3[..., 0])
    u1 = uniform_from_bits(rng_key3[..., 1])
    u2 = uniform_from_bits(rng_key3[..., 2])
    S = torch.clamp(stream.mat_tex_size[mc], min=1)
    max_l = torch.round(torch.log2(S.to(torch.float32))).to(torch.int64)
    l = torch.minimum(torch.clamp(torch.floor(lod + u0).to(torch.int64), min=0), max_l)
    l = torch.maximum(l, stream.mat_resident[mc])            # residency clamp
    l = torch.clamp(l, 0, MIPS - 1)
    Sl = torch.clamp(S >> l, min=1)
    Slf = Sl.to(torch.float32)
    xi = torch.floor(uv[..., 0] * Slf - 0.5 + u1).to(torch.int64) % Sl
    yi = torch.floor(uv[..., 1] * Slf - 0.5 + u2).to(torch.int64) % Sl
    flat = mc * MIPS + l
    tail_off = stream.tail_off.reshape(-1)
    row_t = tail_off[flat] + yi * Sl + xi                    # tail: dense rows
    tiles_x = torch.clamp(Sl // TILE, min=1)                 # streamed: tile -> page
    vt = stream.vt_base.reshape(-1)[flat] + (yi // TILE) * tiles_x + (xi // TILE)
    V = stream.page_table.shape[0]
    page = stream.page_table[torch.clamp(vt, 0, V - 1)]
    row_s = stream.pool_base + page * PAGE_TEXELS + (yi % TILE) * TILE + (xi % TILE)
    # page < 0 cannot happen at mips >= mat_resident; guard with the 1x1 tail
    idx = torch.where(Sl <= TAIL_MAX, row_t,
                      torch.where(page >= 0, row_s, tail_off[mc * MIPS + MIPS - 1]))
    rows = stream.tex_pool[torch.clamp(idx, 0, stream.tex_pool.shape[0] - 1)]
    return _decode_rows(rows)


def texture_feedback(mat, lod, n_mats: int, stride: int = 4):
    """The per-frame sampler-feedback resolve: a strided (mat, mip) demand
    histogram before the residency clamp. mat (H, W) int, lod (H, W) f32 ->
    (n_mats, MAX_MIPS) int64 counts (an integer scatter-add: the same counts
    on the card and the CPU, with no host sync)."""
    from hobbyrenderer_tpu_torch.scene.textures import MAX_MIPS
    m = torch.clamp(mat[::stride, ::stride], 0, n_mats - 1)
    l = torch.clamp(torch.floor(lod[::stride, ::stride]).to(torch.int64), 0, MAX_MIPS - 1)
    seg = (m * MAX_MIPS + l).reshape(-1)
    hist = torch.zeros(n_mats * MAX_MIPS, dtype=torch.int64, device=seg.device)
    return hist.index_add_(0, seg, torch.ones_like(seg)).reshape(n_mats, MAX_MIPS)


def _ddx(img):
    d = img[:, 1:] - img[:, :-1]
    return torch.cat([d, d[:, -1:]], dim=1)


def _ddy(img):
    d = img[1:] - img[:-1]
    return torch.cat([d, d[-1:]], dim=0)


def uv_lod(uv_img, tex_size_img):
    """Mip level from screen-space uv derivatives, min-magnitude of the
    forward/backward difference per axis (see the JAX version)."""
    def two_sided(d, axis):
        if axis == 1:
            bwd = torch.cat([d[:, :1], d[:, :-1]], dim=1)
        else:
            bwd = torch.cat([d[:1], d[:-1]], dim=0)
        d = d - torch.round(d)
        bwd = bwd - torch.round(bwd)
        return torch.minimum(torch.abs(d).amax(-1), torch.abs(bwd).amax(-1))

    foot = torch.maximum(two_sided(_ddx(uv_img), 1), two_sided(_ddy(uv_img), 0))
    return torch.log2(torch.clamp(foot * tex_size_img, min=1e-6))


def cotangent_frame(n, pos, uv):
    """Per-pixel tangent frame from screen-space derivatives (Schüler)."""
    dp1, dp2 = _ddx(pos), _ddy(pos)
    duv1, duv2 = _ddx(uv), _ddy(uv)
    duv1 = duv1 - torch.round(duv1)
    duv2 = duv2 - torch.round(duv2)
    dp2perp = tm.cross(dp2, n)
    dp1perp = tm.cross(n, dp1)
    T = dp2perp * duv1[..., 0:1] + dp1perp * duv2[..., 0:1]
    B = dp2perp * duv1[..., 1:2] + dp1perp * duv2[..., 1:2]
    invmax = torch.rsqrt(torch.clamp(torch.maximum(
        torch.sum(T * T, -1, keepdim=True), torch.sum(B * B, -1, keepdim=True)),
        min=1e-20))
    return T * invmax, B * invmax


def apply_normal_map(n, pos, uv, n_ts):
    """Perturb world normal n by tangent-space sample n_ts."""
    T, B = cotangent_frame(n, pos, uv)
    degenerate = torch.sum(T * T, -1, keepdim=True) < 1e-12
    m = n_ts[..., 0:1] * T + n_ts[..., 1:2] * B + n_ts[..., 2:3] * n
    m = m / torch.clamp(torch.linalg.vector_norm(m, dim=-1, keepdim=True), min=1e-8)
    return torch.where(degenerate, n, m)
