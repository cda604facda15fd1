"""Cascaded shadow maps, the NormalBasic sun-shadow path (counterpart of
hobbyrenderer_tpu/ops/csm.py).

Four sphere-fit, texel-snapped orthographic cascades from the sun; their
casters are culled as one (cascade, pair) mask and rasterized depth-only
into one atlas by the tile-raster kernel K5 (ops/raster.py::
rasterize_shadow_atlas). The mask pass picks a cascade per pixel, applies a
normal offset scaled by that cascade's texel, and takes a 2x2 PCF tap."""

from __future__ import annotations

from typing import NamedTuple

import torch

from hobbyrenderer_tpu_torch.ops import culling as cullops
from hobbyrenderer_tpu_torch.ops import raster as rasterops

NUM_CASCADES = 4
SHADOW_RES = 1024
SPLIT_LAMBDA = 0.6      # log/uniform blend of the split distances
# per-cascade shadow LOD bias: far cascades cover a large area per texel
CASCADE_LOD_BIAS = (1, 1, 2, 3)


class CSMData(NamedTuple):
    view_proj: torch.Tensor   # (C, 4, 4) light clip from world
    depth: torch.Tensor       # (C, S, S) reversed-Z light depth (1 = near light)
    splits: torch.Tensor      # (C,) far split view distances


def _normalize(v):
    return v / torch.clamp(torch.linalg.vector_norm(v), min=1e-8)


def _look_at(eye, center, up):
    fwd = _normalize(center - eye)
    right = _normalize(torch.linalg.cross(fwd, up))
    u = torch.linalg.cross(right, fwd)
    m = torch.eye(4, dtype=torch.float32, device=eye.device)
    m[0, :3], m[1, :3], m[2, :3] = right, u, -fwd
    m[:3, 3] = -(m[:3, :3] @ eye)
    return m


def _ortho(r, near: float, far):
    """Symmetric ortho box [-r, r]^2, reversed-Z depth in [0, 1]."""
    m = torch.eye(4, dtype=torch.float32, device=r.device)
    m[0, 0] = 1.0 / r
    m[1, 1] = 1.0 / r
    m[2, 2] = 1.0 / (far - near)
    m[2, 3] = far / (far - near)
    return m


def frustum_planes(m):
    """(6, 4) inward planes of a clip matrix (utils/math.py's extraction:
    left, right, bottom, top, near, and a never-culling far plane)."""
    rows = [m[3] + m[0], m[3] - m[0], m[3] + m[1], m[3] - m[1], m[2]]
    planes = [r / torch.clamp(torch.sqrt(torch.sum(r[:3] * r[:3])), min=1e-20) for r in rows]
    far = torch.zeros(4, dtype=torch.float32, device=m.device)
    far[3] = 1.0
    return torch.stack(planes + [far])


def cascade_matrices(vc, sun_dir, max_distance: float):
    """Sphere-fit cascade view-proj matrices (C, 4, 4) and far splits (C,):
    log/uniform-blended splits, one bounding sphere per slice on the view
    ray, the light-space centre snapped to the texel grid."""
    dev = sun_dir.device

    def f32(x):
        # a device scalar from a fill, not a host copy (which would sync)
        return torch.full((), x, dtype=torch.float32, device=dev)

    near = f32(vc["znear"])
    cam = vc["camera_pos"]
    fwd = -vc["view"][2, :3]
    steep = (torch.abs(sun_dir[1]) > 0.95).to(torch.float32)
    up = torch.stack([steep, 1.0 - steep, torch.zeros_like(steep)])   # x if steep, else y
    i = torch.arange(NUM_CASCADES + 1, dtype=torch.float32, device=dev) / NUM_CASCADES
    log_split = near * (max_distance / near) ** i
    uni_split = near + (max_distance - near) * i
    splits = SPLIT_LAMBDA * log_split + (1 - SPLIT_LAMBDA) * uni_split
    inv_p11 = 1.0 / f32(vc["proj11"])
    inv_p00 = 1.0 / f32(vc["proj00"])
    vps = []
    for c in range(NUM_CASCADES):
        n_d, f_d = splits[c], splits[c + 1]
        rx = f_d * inv_p00
        ry = f_d * inv_p11
        center = cam + fwd * (0.5 * (n_d + f_d))
        radius = torch.sqrt((0.5 * (f_d - n_d)) ** 2 + rx * rx + ry * ry)
        texel = (2.0 * radius) / SHADOW_RES
        eye = center - sun_dir * (radius * 2.0)
        V = _look_at(eye, center, up)
        c_ls = V[:3, :3] @ center + V[:3, 3]
        V[:2, 3] += torch.round(c_ls[:2] / texel) * texel - c_ls[:2]
        vps.append(_ortho(radius, 0.0, radius * 4.0) @ V)
    return torch.stack(vps), splits[1:]


def render_cascades(gpu, vc, sun_dir, visible_capacity: int,
                    max_distance: float) -> CSMData:
    """Depth-only meshlet raster of all cascades in one atlas pass: one
    (cascade, pair) culling mask (LODs from the main camera plus each
    cascade's bias; opaque and masked instances cast), compacted cascade
    major, and one K5 call."""
    vps, splits = cascade_matrices(vc, sun_dir, max_distance)
    sel = cullops.select_instance_lods(gpu, vc)
    lc = gpu.prim_lod_count[gpu.inst_prim]
    sel_c = torch.stack([torch.minimum(sel + b, lc - 1)
                         for b in CASCADE_LOD_BIAS[:NUM_CASCADES]])            # (C, N)
    inst = gpu.pair_inst
    ml = gpu.pair_meshlet
    base = gpu.inst_alpha_mode[inst] < 2
    W = gpu.inst_transform[inst]
    c_w = torch.einsum("dij,dj->di", W[:, :3, :3], gpu.ml_center[ml]) + W[:, :3, 3]
    r_w = gpu.ml_radius[ml] * gpu.inst_scale_max[inst]
    planes = torch.stack([frustum_planes(vps[c]) for c in range(NUM_CASCADES)])
    d = torch.einsum("dj,ckj->cdk", c_w, planes[..., :3]) + planes[:, None, :, 3]
    in_f = torch.all(d >= -r_w[None, :, None], dim=-1)                     # (C, D)
    mask4 = in_f & base[None, :] & (gpu.pair_lod[None, :] == sel_c[:, inst])
    # cascade-major flatten: on overflow, far-cascade casters drop first
    slots, _cnt = cullops.compact_mask(mask4.reshape(-1), visible_capacity)
    depth = rasterops.rasterize_shadow_atlas(gpu, vps, slots, SHADOW_RES)
    return CSMData(view_proj=vps, depth=depth, splits=splits)


CASCADE_COLORS = ((1.0, 0.25, 0.25), (0.25, 1.0, 0.25),
                  (0.3, 0.45, 1.0), (1.0, 1.0, 0.3))


def csm_debug_overlay(ldr, csm: CSMData, vc, world_pos, valid):
    """The cascade debug view: each pixel tinted by its selected cascade,
    and the cascade depth maps inset as thumbnails along the bottom edge.
    ldr (H, W, 3) uint8 -> uint8."""
    H, W = ldr.shape[0], ldr.shape[1]
    V = vc["view"]
    dist = -(torch.einsum("ij,hwj->hwi", V[:3, :3], world_pos) + V[:3, 3])[..., 2]
    cidx = torch.clamp(torch.sum((dist[..., None] > csm.splits).to(torch.int64), -1),
                       0, NUM_CASCADES - 1)
    colors = torch.tensor(CASCADE_COLORS, dtype=torch.float32, device=ldr.device)
    out = ldr.to(torch.float32) / 255.0
    out = torch.where(valid[..., None], out * 0.65 + colors[cidx] * 0.35, out)
    # thumbnails: a strided subsample of each cascade's depth map
    th = max(H // 5, 8)
    s = max(SHADOW_RES // th, 1)
    pad = 8
    for c in range(NUM_CASCADES):
        x0 = pad + c * (th + pad)
        if x0 + th > W:
            break
        thumb = csm.depth[c][::s, ::s][:th, :th]              # reversed-Z
        img = thumb[..., None] * (0.75 * colors[c] + 0.25)
        # the JAX package's dynamic_update_slice clamps the corner into the frame
        y0 = min(max(H - th - pad, 0), H - img.shape[0])
        out[y0:y0 + img.shape[0], x0:x0 + img.shape[1]] = img
    return torch.clamp(torch.round(out * 255.0), 0, 255).to(torch.uint8)


def csm_shadow_mask(csm: CSMData, vc, world_pos, normal, valid, sun_dir):
    """Visibility mask (H, W) of the shading points: cascade select by view
    distance, normal offset by the selected cascade's texel, 2x2 PCF with a
    depth bias; lit past the last cascade and on invalid pixels."""
    V = vc["view"]
    p_view = torch.einsum("ij,hwj->hwi", V[:3, :3], world_pos) + V[:3, 3]
    dist = -p_view[..., 2]
    cidx = torch.sum((dist[..., None] > csm.splits[None, None, :]).to(torch.int64), dim=-1)
    cidx = torch.clamp(cidx, 0, NUM_CASCADES - 1)
    vp = csm.view_proj[cidx]                                    # (H, W, 4, 4)
    ndl = torch.abs(torch.sum(normal * (-sun_dir), -1, keepdim=True))
    texel_world = ((4.0 * csm.splits[cidx] / NUM_CASCADES) / SHADOW_RES)[..., None]
    p = world_pos + normal * (texel_world * 2.0 * (1.0 + (1.0 - ndl)))
    clip = torch.einsum("hwij,hwj->hwi", vp[..., :3, :3], p) + vp[..., :3, 3]
    u = torch.clamp(clip[..., 0] * 0.5 + 0.5, 0.0, 1.0)
    v = torch.clamp(0.5 - clip[..., 1] * 0.5, 0.0, 1.0)
    z = clip[..., 2]
    S = SHADOW_RES
    x = torch.clamp((u * S).to(torch.int64), 0, S - 1)
    y = torch.clamp((v * S).to(torch.int64), 0, S - 1)
    # the 2x2 footprint, edge-clamped: the JAX package packs it into a quad
    # table first; the four taps read the same texels
    d = csm.depth.reshape(-1)
    x1 = torch.clamp(x + 1, max=S - 1)
    y1 = torch.clamp(y + 1, max=S - 1)
    base = cidx * (S * S)
    q = torch.stack([d[base + y * S + x], d[base + y * S + x1],
                     d[base + y1 * S + x], d[base + y1 * S + x1]], -1)
    # occluded when a surface nearer to the light exists (larger depth), past
    # a depth bias
    vis = torch.mean(torch.where(q > (z + 2e-3)[..., None], 0.0, 1.0), -1)
    vis = torch.where(dist > csm.splits[-1], 1.0, vis)
    return torch.where(valid, vis, 1.0)
