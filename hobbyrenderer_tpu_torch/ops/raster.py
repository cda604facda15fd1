"""Software meshlet rasterizer -> visibility buffer -> G-buffer resolve.

Counterpart of hobbyrenderer_tpu/ops/raster.py, kernel branch only: visible
meshlet slots are transformed, expanded to per-triangle plane records, binned
into a tile-sorted (tile, 32-triangle chunk) worklist, and rasterized with
the fused tile-raster + attribute-resolve kernel (K1, ops/raster_kernel.py).
The cascaded-shadow atlas (``rasterize_shadow_atlas``) goes the same way
through the depth-only tile raster (K5). The capacities, the worklist order
and the visid encoding (slot * 96 + tri) are the JAX package's, so visids
compare across the two packages."""

from __future__ import annotations

from typing import NamedTuple

import torch

from hobbyrenderer_tpu_torch.scene.cooker import MESHLET_MAX_TRIS, MESHLET_MAX_VERTS
from hobbyrenderer_tpu_torch.ops import raster_kernel as rk
from hobbyrenderer_tpu_torch.ops import texture as texops
from hobbyrenderer_tpu_torch.scene.gpu import (MAT_ALPHA_CUTOFF, MAT_BASE_COLOR,
                                               MAT_EMISSIVE, MAT_METALLIC,
                                               MAT_ROUGHNESS, MAT_TEX_BASE_HI,
                                               MAT_TEX_BASE_LO, MAT_TEX_SIZE,
                                               MAT_UV_SCALE, MATI_DOUBLE_SIDED)
from hobbyrenderer_tpu_torch.utils import tmath as tm
from hobbyrenderer_tpu_torch.utils.rng import pcg3d

TILE = 32


class RasterOutput(NamedTuple):
    depth: torch.Tensor     # (H, W) f32 reversed-Z, 0 = far
    visid: torch.Tensor     # (H, W) int64: slot * 96 + tri, -1 = none
    overflow: torch.Tensor  # () worklist items dropped past capacity


class RasterAux(NamedTuple):
    tri_screen: torch.Tensor  # (C, 96, 3, 4): screen x, y, z_ndc, 1/w
    tri_attr: torch.Tensor    # (C, 96, 3, 12): pos3 nrm3 uv2 prev3 mat1


class GBuffer(NamedTuple):
    albedo: torch.Tensor
    normal: torch.Tensor
    geo_normal: torch.Tensor
    orm: torch.Tensor
    emissive: torch.Tensor
    motion: torch.Tensor
    world_pos: torch.Tensor
    depth: torch.Tensor
    material: torch.Tensor
    valid: torch.Tensor
    alpha: torch.Tensor = None


def _transform_meshlet_vertices(gpu, vc, slots, slot_valid):
    """Gather + transform each visible meshlet slot's 64 vertices.
    Returns (screen (C,64,2), zndc, w, vert_ok, meshlet ids, p_world)."""
    inst = torch.where(slot_valid, gpu.pair_inst[slots.clamp(min=0)], 0)
    ml = torch.where(slot_valid, gpu.pair_meshlet[slots.clamp(min=0)], 0)
    vcnt = gpu.ml_vert_count[ml]
    lanes = torch.arange(MESHLET_MAX_VERTS, device=slots.device)[None, :]
    vert_valid = lanes < vcnt[:, None]
    p_obj = gpu.ml_pos[ml]
    W = gpu.inst_transform[inst]
    p_world = torch.einsum("cij,cvj->cvi", W[:, :3, :3], p_obj) + W[:, None, :3, 3]
    VP = vc["view_proj"]
    clip = torch.einsum("ij,cvj->cvi", VP[:3, :3], p_world) + VP[:3, 3][None, None, :]
    w = torch.einsum("j,cvj->cv", VP[3, :3], p_world) + VP[3, 3]
    w_safe = torch.where(w > 1e-6, w, 1.0)
    ndc = clip / w_safe[..., None]
    width, height = vc["viewport"]
    sx = (ndc[..., 0] * 0.5 + 0.5) * width
    sy = (0.5 - ndc[..., 1] * 0.5) * height
    screen = torch.stack([sx, sy], -1)
    return screen, ndc[..., 2], w, vert_valid & (w > 1e-6), ml, p_world


def _tri_onehot(gpu, ml, slot_valid):
    """Meshlet-local triangle vertex indices (C, 96, 3) + (C, 96) validity.
    (The JAX package expands per-vertex features with a one-hot matmul on
    the MXU; a gather by these indices yields the same values exactly.)"""
    tcnt = gpu.ml_tri_count[ml]
    lanes = torch.arange(MESHLET_MAX_TRIS, device=ml.device)[None, :]
    lt = gpu.ml_ltris[ml]
    tri_valid = (lanes < tcnt[:, None]) & slot_valid[:, None]
    return lt, tri_valid


def _tri_expand(lt, feats):
    """lt (C, 96, 3) vertex ids, feats (C, 64, F) -> (C, 96, 3, F)."""
    C, _, F = feats.shape
    idx = lt.reshape(C, MESHLET_MAX_TRIS * 3, 1).expand(-1, -1, F)
    return torch.gather(feats, 1, idx).reshape(C, MESHLET_MAX_TRIS, 3, F)


def build_raster_aux(gpu, slots, slot_valid, screen, zndc, w, ml, p_world,
                     lt) -> RasterAux:
    """Per-slot-triangle records: screen setup + world attributes."""
    inst = torch.where(slot_valid, gpu.pair_inst[slots.clamp(min=0)], 0)
    attr = gpu.ml_attr[ml]
    n_obj, _sign = tm.unpack_normal_oct(attr[..., 0])
    uv = tm.unpack_uv_half2(attr[..., 1])
    Nm = gpu.inst_normal_mat[inst]
    n_world = torch.einsum("cij,cvj->cvi", Nm, n_obj)
    Wp = gpu.inst_prev_transform[inst]
    p_obj = gpu.ml_pos[ml]
    p_prev = torch.einsum("cij,cvj->cvi", Wp[:, :3, :3], p_obj) + Wp[:, None, :3, 3]
    matf = gpu.inst_material[inst].to(torch.float32)
    C, V = p_world.shape[0], p_world.shape[1]
    attr_feats = torch.cat([p_world, n_world, uv, p_prev,
                            matf[:, None, None].expand(C, V, 1)], -1)
    tri_attr = _tri_expand(lt, attr_feats)
    scr_feats = torch.cat([screen, zndc[..., None],
                           (1.0 / torch.clamp(w, min=1e-6))[..., None]], -1)
    tri_screen = _tri_expand(lt, scr_feats)
    return RasterAux(tri_screen=tri_screen, tri_attr=tri_attr)


def build_worklist(screen, vert_ok, slot_valid, width, height, capacity: int,
                   sub_count, n_sub: int):
    """Meshlet screen AABB -> flat tile-sorted (tile, chunk-slot) worklist.

    sub_count (C,) in [1, n_sub]: live 32-triangle chunks per slot; item ids
    are slot * n_sub + chunk. Returns (work_tile, work_slot) int32 (Wcap,)
    sorted stably by tile (sentinel tile T for padding), the clamped count
    and the overflow (items dropped past capacity)."""
    dev = screen.device
    big = 1e9
    mn = torch.amin(torch.where(vert_ok[..., None], screen, big), dim=1)
    mx = torch.amax(torch.where(vert_ok[..., None], screen, -big), dim=1)
    any_vert = vert_ok.any(1) & slot_valid
    tx = -(-width // TILE)
    ty = -(-height // TILE)
    hi = torch.tensor([tx - 1, ty - 1], device=dev)
    t0 = torch.minimum(torch.clamp(torch.floor(mn / TILE).to(torch.int64), min=0), hi)
    t1 = torch.minimum(torch.clamp(torch.floor(mx / TILE).to(torch.int64), min=0), hi)
    on_screen = (mx[:, 0] >= 0) & (mx[:, 1] >= 0) & (mn[:, 0] < width) & (mn[:, 1] < height)
    ok = any_vert & on_screen
    C_ = screen.shape[0]
    T = tx * ty
    bx0, bx1 = t0[:, 0], t1[:, 0]
    by0, by1 = t0[:, 1], t1[:, 1]
    nx = bx1 - bx0 + 1
    nyc = by1 - by0 + 1
    sub = torch.clamp(sub_count, 1, n_sub)
    n = torch.where(ok, nx * nyc * sub, 0)

    offs = torch.cumsum(n, 0) - n
    count = torch.sum(n)
    overflow = torch.clamp(count - capacity, min=0)
    heads = torch.full((capacity + 1,), -1, dtype=torch.int64, device=dev)
    dst = torch.where(ok & (offs < capacity), offs, capacity)
    heads = heads.scatter_reduce(0, dst, torch.arange(C_, device=dev), "amax")
    work_slot = torch.cummax(heads[:capacity], 0).values
    pos_in_work = torch.arange(capacity, device=dev)
    valid = (pos_in_work < count) & (work_slot >= 0)
    ws = torch.clamp(work_slot, min=0)
    k = pos_in_work - offs[ws]
    sub_ws = torch.clamp(sub[ws], min=1)
    ksub = k % sub_ws
    k = k // sub_ws
    nx_ws = torch.clamp(nx[ws], min=1)
    dx = k % nx_ws
    dy = k // nx_ws
    tile = (by0[ws] + dy) * tx + (bx0[ws] + dx)
    tile = torch.where(valid, tile, T)
    work_slot = torch.where(valid, ws * n_sub + ksub, -1)
    order = torch.argsort(tile, stable=True)
    return (tile[order].to(torch.int32), work_slot[order].to(torch.int32),
            torch.clamp(count, max=capacity), overflow)


def _tri_affine_coeffs(tv, tz, inv_a2, tok):
    """Per-triangle plane equations (C, 96, 10):
    [l1x,l1y,l1c, l2x,l2y,l2c, dx,dy,dc, ok]."""
    va, vb, vc2 = tv[..., 0, :], tv[..., 1, :], tv[..., 2, :]

    def edge_affine(p0, p1):
        d = p1 - p0
        return (-d[..., 1], d[..., 0],
                d[..., 1] * p0[..., 0] - d[..., 0] * p0[..., 1])

    bx, by, bc = edge_affine(vc2, va)
    cx, cy, cc = edge_affine(va, vb)
    l1x, l1y, l1c = bx * inv_a2, by * inv_a2, bc * inv_a2
    l2x, l2y, l2c = cx * inv_a2, cy * inv_a2, cc * inv_a2
    z0, z1, z2 = tz[..., 0], tz[..., 1], tz[..., 2]
    dx = l1x * (z1 - z0) + l2x * (z2 - z0)
    dy = l1y * (z1 - z0) + l2y * (z2 - z0)
    dc = z0 + l1c * (z1 - z0) + l2c * (z2 - z0)
    return torch.stack([l1x, l1y, l1c, l2x, l2y, l2c, dx, dy, dc,
                        tok.to(torch.float32)], -1)


def rasterize(gpu, vc, slots, width: int, height: int):
    """Rasterize visible meshlet slots (C,) int64 (-1 padded) into a
    visibility buffer with fused attribute resolve.

    Returns (RasterOutput, attr image (H, W, 16))."""
    C = slots.shape[0]
    worklist_capacity = max(8 * C, 4096)
    slot_valid = slots >= 0
    screen, zndc, w, vert_ok, ml, p_world = _transform_meshlet_vertices(
        gpu, vc, slots, slot_valid)
    lt, tri_valid = _tri_onehot(gpu, ml, slot_valid)
    tri_feats = _tri_expand(lt, torch.cat(
        [screen, zndc[..., None], vert_ok.to(torch.float32)[..., None]], -1))
    tv = tri_feats[..., 0:2]
    tz = tri_feats[..., 2]
    tok = (tri_feats[..., 3] > 0.5).all(-1) & tri_valid
    aux = build_raster_aux(gpu, slots, slot_valid, screen, zndc, w, ml,
                           p_world, lt)

    e1 = tv[:, :, 1] - tv[:, :, 0]
    e2 = tv[:, :, 2] - tv[:, :, 0]
    area2 = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]
    inst = torch.where(slot_valid, gpu.pair_inst[slots.clamp(min=0)], 0)
    ds = gpu.mat_i[gpu.inst_material[inst], MATI_DOUBLE_SIDED] > 0
    tok = tok & ((area2 < 0.0) | ds[:, None])
    nondegen = torch.abs(area2) > 1e-12
    tok = tok & nondegen
    inv_a2 = torch.where(nondegen, 1.0 / area2, 0.0)

    tx = -(-width // TILE)
    ty = -(-height // TILE)
    T = tx * ty
    coeff = _tri_affine_coeffs(tv, tz, inv_a2, tok)

    Hp, Wp = ty * TILE, tx * TILE
    tri_cnt = torch.where(slot_valid, gpu.ml_tri_count[ml], 1)
    slot_chunks = torch.clamp((tri_cnt + rk.TRI_CHUNK - 1) // rk.TRI_CHUNK,
                              1, rk.N_CHUNKS)
    work_tile, work_slot, _count, overflow = build_worklist(
        screen, vert_ok, slot_valid, width, height, 2 * worklist_capacity,
        sub_count=slot_chunks, n_sub=rk.N_CHUNKS)
    records = rk.build_full_records(coeff, aux.tri_screen, aux.tri_attr)
    records = records.reshape(-1, rk.TRI_CHUNK, records.shape[-1])
    depth_t, vis_t, attr_t = rk.raster_resolve_tiles(
        records, work_tile, work_slot, tiles=T, tx=tx)
    attr_img = (attr_t.reshape(ty, tx, rk.ATTR_ROWS, TILE, TILE)
                .permute(0, 3, 1, 4, 2).reshape(Hp, Wp, rk.ATTR_ROWS)
                [:height, :width])
    depth_img = depth_t.reshape(ty, tx, TILE, TILE).permute(0, 2, 1, 3).reshape(Hp, Wp)
    vis_img = vis_t.reshape(ty, tx, TILE, TILE).permute(0, 2, 1, 3).reshape(Hp, Wp)
    out = RasterOutput(depth_img[:height, :width],
                       vis_img[:height, :width].to(torch.int64), overflow)
    return out, attr_img


def rasterize_shadow_atlas(gpu, vps, slots, res: int):
    """Depth-only raster of N light views into one vertical atlas, one K5
    call: a slot encodes (view, pair) as ``view * num_pairs + pair``, its
    meshlet is projected with the view's matrix and offset by ``view * res``
    rows, and the tile worklist spans the (N * res, res) target.

    vps (N, 4, 4) light view-proj matrices; slots (C,) int64 compacted
    (view, pair) ids (-1 padded). Returns depth (N, res, res), reversed-Z."""
    n_views = vps.shape[0]
    D = gpu.pair_inst.shape[0]
    C = slots.shape[0]
    slot_valid = slots >= 0
    s = torch.where(slot_valid, slots, 0)
    view_i = s // D
    pair = s % D
    inst = gpu.pair_inst[pair]
    ml = gpu.pair_meshlet[pair]
    vcnt = gpu.ml_vert_count[ml]
    lanes = torch.arange(MESHLET_MAX_VERTS, device=slots.device)[None, :]
    vert_valid = lanes < vcnt[:, None]
    p_obj = gpu.ml_pos[ml]
    W = gpu.inst_transform[inst]
    p_world = torch.einsum("cij,cvj->cvi", W[:, :3, :3], p_obj) + W[:, None, :3, 3]
    VP = vps[view_i]
    clip = torch.einsum("cij,cvj->cvi", VP[:, :3, :3], p_world) + VP[:, None, :3, 3]
    w = torch.einsum("cj,cvj->cv", VP[:, 3, :3], p_world) + VP[:, 3, 3][:, None]
    w_safe = torch.where(w > 1e-6, w, 1.0)
    ndc = clip / w_safe[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * res
    sy = (0.5 - ndc[..., 1] * 0.5) * res + (view_i * res)[:, None].to(torch.float32)
    screen = torch.stack([sx, sy], -1)
    vert_ok = vert_valid & (w > 1e-6)

    lt, tri_valid = _tri_onehot(gpu, ml, slot_valid)
    tri_feats = _tri_expand(lt, torch.cat(
        [screen, ndc[..., 2:3], vert_ok.to(torch.float32)[..., None]], -1))
    tv = tri_feats[..., 0:2]
    tz = tri_feats[..., 2]
    tok = (tri_feats[..., 3] > 0.5).all(-1) & tri_valid           # double-sided
    e1 = tv[:, :, 1] - tv[:, :, 0]
    e2 = tv[:, :, 2] - tv[:, :, 0]
    area2 = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]
    nondegen = torch.abs(area2) > 1e-12
    tok = tok & nondegen
    inv_a2 = torch.where(nondegen, 1.0 / area2, 0.0)
    coeff = _tri_affine_coeffs(tv, tz, inv_a2, tok)

    tx = res // TILE
    ty = n_views * res // TILE
    tri_cnt = torch.where(slot_valid, gpu.ml_tri_count[ml], 1)
    slot_chunks = torch.clamp((tri_cnt + rk.TRI_CHUNK - 1) // rk.TRI_CHUNK, 1, rk.N_CHUNKS)
    work_tile, work_slot, _count, _overflow = build_worklist(
        screen, vert_ok, slot_valid, res, n_views * res, 2 * max(8 * C, 4096),
        sub_count=slot_chunks, n_sub=rk.N_CHUNKS)
    records = rk.build_tri_records(coeff)
    records = records.reshape(-1, rk.TRI_CHUNK, records.shape[-1])
    depth_t, _vis = rk.raster_tiles(records, work_tile, work_slot, tiles=tx * ty, tx=tx,
                                    depth_only=True)
    depth = depth_t.reshape(ty, tx, TILE, TILE).permute(0, 2, 1, 3).reshape(ty * TILE, res)
    return depth.reshape(n_views, res, res)


def resolve_gbuffer(gpu, vc, raster: RasterOutput, attr_img, pix_ids=None,
                    want_feedback: bool = False, want_tex_debug: bool = False):
    """Per-pixel G-buffer from the kernel's interpolated attributes (H, W, 16):
    material constants, stochastic-trilinear texturing, normal mapping and
    motion vectors. ``pix_ids`` (H, W) global pixel ids let a caller resolve
    a compacted lane list: texture LOD then comes from the distance cone (no
    screen derivatives across lanes) and normal maps are skipped.

    Under texture streaming (``gpu.tex_stream``) every table is textured
    through the residency tables, even an untextured one; ``want_feedback``
    then also returns the (Mat, MAX_MIPS) demand histogram (None without
    streaming), and ``want_tex_debug`` that and the (H, W) residency clamp:
    how many mips coarser each textured pixel's sample came back than its
    footprint asked for. Returns the GBuffer, (GBuffer, feedback) or
    (GBuffer, feedback, clamp)."""
    H, W = raster.depth.shape
    dev = raster.depth.device
    valid = raster.visid >= 0

    pos_w = attr_img[..., 0:3]
    n_shade = tm.normalize(attr_img[..., 3:6])
    uv_pix = attr_img[..., 6:8]
    prev_pos = attr_img[..., 8:11]
    mat = torch.round(attr_img[..., 11]).to(torch.int64)
    gn = tm.normalize(attr_img[..., 12:15])
    flip = torch.sum(gn * n_shade, -1, keepdim=True) < 0
    gn = torch.where(flip, -gn, gn)

    # material row per pixel (the JAX one-hot matmul selects the same row;
    # out-of-range ids get a zero row there, and here)
    Mt = gpu.mat_f.shape[0]
    in_range = (mat >= 0) & (mat < Mt)
    mf = torch.where(in_range[..., None], gpu.mat_f[mat.clamp(0, Mt - 1)], 0.0)
    albedo = mf[..., MAT_BASE_COLOR:MAT_BASE_COLOR + 3]
    alpha = mf[..., MAT_BASE_COLOR + 3]
    metallic = mf[..., MAT_METALLIC]
    rough = mf[..., MAT_ROUGHNESS]
    emissive = mf[..., MAT_EMISSIVE:MAT_EMISSIVE + 3]
    occlusion = torch.ones((H, W), dtype=torch.float32, device=dev)

    tex_feedback = tex_clamp = None
    stream = gpu.tex_stream
    if stream is not None or gpu.tex_table.shape[0] > gpu.mat_f.shape[0]:
        tex_size = mf[..., MAT_TEX_SIZE]
        tex_base = (torch.round(mf[..., MAT_TEX_BASE_HI]).to(torch.int64) * 4096
                    + torch.round(mf[..., MAT_TEX_BASE_LO]).to(torch.int64))
        uv_s = uv_pix * torch.clamp(mf[..., MAT_UV_SCALE:MAT_UV_SCALE + 1], min=1e-6)
        if pix_ids is not None:
            spread = 2.0 / (vc["proj11"] * vc["viewport"][1])
            dist = torch.linalg.vector_norm(pos_w - vc["camera_pos"], dim=-1)
            lod = torch.log2(torch.clamp(tex_size * dist * spread, min=1e-6))
            pix = pix_ids.to(torch.int64)
        else:
            lod = texops.uv_lod(uv_s, tex_size)
            pix = torch.arange(H * W, dtype=torch.int64, device=dev).reshape(H, W)
        key = pcg3d(torch.stack([pix, torch.full_like(pix, vc["frame_index"]),
                                 torch.full_like(pix, 311)], -1))
        if stream is not None:
            # residency-clamped sampling, and the demand histogram the host
            # streamer consumes
            ts = texops.sample_material_streamed(stream, mat, uv_s, lod, key)
            if want_feedback or want_tex_debug:
                tex_feedback = texops.texture_feedback(torch.where(valid, mat, 0),
                                                       torch.where(valid, lod, 30.0),
                                                       gpu.mat_f.shape[0])
            if want_tex_debug:
                Mres = stream.mat_resident.shape[0]
                res_mip = stream.mat_resident[torch.clamp(mat, 0, Mres - 1)].to(torch.float32)
                tex_clamp = torch.clamp(res_mip - torch.clamp(lod, min=0.0), min=0.0)
                tex_clamp = torch.where(valid & (tex_size > 1.5), tex_clamp, 0.0)
        else:
            ts = texops.sample_material(gpu, tex_size, tex_base, uv_s, lod, key)
        albedo = albedo * ts.albedo
        alpha = alpha * ts.alpha
        rough = rough * ts.roughness
        metallic = metallic * ts.metallic
        emissive = emissive * ts.emissive
        occlusion = ts.occlusion
        if pix_ids is None:
            n_shade = texops.apply_normal_map(n_shade, pos_w, uv_s, ts.normal_ts)

    alpha_margin = alpha - mf[..., MAT_ALPHA_CUTOFF]

    width, height = vc["viewport"]
    PVP = vc["prev_view_proj_no_jitter"]
    pw = torch.clamp(prev_pos @ PVP[3, :3] + PVP[3, 3], min=1e-6)
    pclip = prev_pos @ PVP[:3, :3].T + PVP[:3, 3]
    pndc = pclip / pw[..., None]
    psx = (pndc[..., 0] * 0.5 + 0.5) * width
    psy = (0.5 - pndc[..., 1] * 0.5) * height
    NJ = vc["view_proj_no_jitter"]
    cw = torch.clamp(pos_w @ NJ[3, :3] + NJ[3, 3], min=1e-6)
    cclip = pos_w @ NJ[:3, :3].T + NJ[:3, 3]
    cndc = cclip / cw[..., None]
    csx = (cndc[..., 0] * 0.5 + 0.5) * width
    csy = (0.5 - cndc[..., 1] * 0.5) * height
    motion = torch.stack([psx - csx, psy - csy], -1)

    vmask = valid[..., None]
    gb = GBuffer(
        albedo=torch.where(vmask, albedo, 0.0),
        normal=torch.where(vmask, n_shade, 0.0),
        geo_normal=torch.where(vmask, gn, 0.0),
        orm=torch.where(vmask, torch.stack([occlusion, rough, metallic], -1), 0.0),
        emissive=torch.where(vmask, emissive, 0.0),
        motion=torch.where(vmask, motion, 0.0),
        world_pos=torch.where(vmask, pos_w, 0.0),
        depth=torch.where(valid, raster.depth, 0.0),
        material=torch.where(valid, mat, -1),
        valid=valid,
        alpha=torch.where(valid, alpha_margin, 0.0))
    if want_tex_debug:
        return gb, tex_feedback, (tex_clamp if tex_clamp is not None
                                  else torch.zeros((H, W), dtype=torch.float32, device=dev))
    if want_feedback:
        return gb, tex_feedback
    return gb
