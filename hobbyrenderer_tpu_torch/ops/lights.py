"""Polymorphic light pool + power-based RIS presampling (counterpart of
hobbyrenderer_tpu/ops/lights.py).

Light ids index one namespace: [0, n_analytic) analytic (SceneGPU.light_*),
[n_analytic, n_total) emissive triangles in world space. Each light is one
packed 16-channel row, so ReSTIR evaluates a light from in-hand data:
analytic [type, pos3, dir3, color3, range, cone2, 0, 0, 0], emissive
[0, v03, e13, e23, rad3, 1, 0, 0]. Presampling draws ids proportional to
power with the counter RNG (utils/rng.py, bit-exact with the JAX package).

The pool of an animated scene would be refit and refreshed every frame;
that path is not ported (the renderer raises for animated scenes)."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from hobbyrenderer_tpu_torch.ops.shading import _range_falloff
from hobbyrenderer_tpu_torch.scene.scene import LIGHT_DIRECTIONAL, LIGHT_SPOT
from hobbyrenderer_tpu_torch.utils import math as hm
from hobbyrenderer_tpu_torch.utils import tmath as tm
from hobbyrenderer_tpu_torch.utils.rng import pcg3d, uniform_from_bits

PRESAMPLE_TILES = 64
PRESAMPLE_TILE_SIZE = 128     # == the candidate kernel's 128-pixel segment
MAX_EMISSIVE_TRIS = 16384  # pool cap; larger emitters are subsampled


class LightPool(NamedTuple):
    """Flattened polymorphic lights on one device. The two counts are host
    ints (the JAX pool keeps them as device scalars)."""

    n_analytic: int           # SceneGPU analytic slot count (padded size)
    n_total: int              # n_analytic + live emissive tris
    em_v0: torch.Tensor       # (E, 3) f32 world space (E >= 1, padded)
    em_e1: torch.Tensor       # (E, 3)
    em_e2: torch.Tensor       # (E, 3)
    em_rad: torch.Tensor      # (E, 3) emitted radiance
    em_orig: torch.Tensor     # (E,) original flat tri id (-1 = padding)
    em_scale: torch.Tensor    # (E,) subsample power-conservation scale
    power_cdf: torch.Tensor   # (A + E,) normalized inclusive power CDF
    power_pdf: torch.Tensor   # (A + E,) selection probability per light
    packed: torch.Tensor      # (A + E, 16) one row per light (see above)


def _emissive_triangles(scene):
    """Host: every emissive instance's LOD0 triangles in world space, and
    their original flat triangle ids (subsampled above MAX_EMISSIVE_TRIS
    with the radiance scaled to conserve power)."""
    v0s, e1s, e2s, rads, origs = [], [], [], [], []
    tri_base = 0
    for I in scene.instances:
        mesh = scene.meshes[I.prim]
        ntri = mesh.lods[0].indices.shape[0]
        m = scene.materials[I.material]
        em = np.asarray(m.emissive, np.float32) * np.float32(
            getattr(m, "emissive_strength", 1.0))
        if np.any(em > 0):
            pw = hm.transform_points(scene.nodes[I.node].world, mesh.positions)
            tv = pw[mesh.lods[0].indices].astype(np.float32)      # (t, 3, 3)
            v0s.append(tv[:, 0])
            e1s.append(tv[:, 1] - tv[:, 0])
            e2s.append(tv[:, 2] - tv[:, 0])
            rads.append(np.tile(em[None, :], (ntri, 1)))
            origs.append(np.arange(ntri, dtype=np.int32) + tri_base)
        tri_base += ntri
    if not v0s:
        z = np.zeros((1, 3), np.float32)
        return z, z, z, z, np.full((1,), -1, np.int32), np.ones(1, np.float32)
    v0, e1, e2 = (np.concatenate(a, 0) for a in (v0s, e1s, e2s))
    rad = np.concatenate(rads, 0)
    orig = np.concatenate(origs, 0)
    scale_arr = np.ones(v0.shape[0], np.float32)
    if v0.shape[0] > MAX_EMISSIVE_TRIS:
        keep = np.linspace(0, v0.shape[0] - 1, MAX_EMISSIVE_TRIS).astype(int)
        scale = v0.shape[0] / MAX_EMISSIVE_TRIS
        v0, e1, e2, orig = v0[keep], e1[keep], e2[keep], orig[keep]
        rad = rad[keep] * scale
        scale_arr = np.full(v0.shape[0], scale, np.float32)
    return v0, e1, e2, rad, orig, scale_arr


def build_light_pool(scene, gpu) -> LightPool:
    """Collect emissive triangles (LOD0, world space) + the analytic lights
    into one pool on ``gpu.device``."""
    v0, e1, e2, rad, orig, scale = _emissive_triangles(scene)
    A = gpu.light_type.shape[0]
    ne = int((np.abs(rad).sum(-1) > 0).sum())

    def t(a):
        return torch.as_tensor(a, device=gpu.device)

    E = v0.shape[0]
    pool = LightPool(n_analytic=A, n_total=A + ne, em_v0=t(v0), em_e1=t(e1),
                     em_e2=t(e2), em_rad=t(rad), em_orig=t(orig.astype(np.int64)),
                     em_scale=t(scale), power_cdf=torch.zeros(A + E, device=gpu.device),
                     power_pdf=torch.zeros(A + E, device=gpu.device), packed=None)
    return refresh_pool_power(pool, gpu)


def _analytic_power(gpu) -> torch.Tensor:
    lum = tm.luminance(gpu.light_color)
    p = torch.where(gpu.light_type == LIGHT_DIRECTIONAL, lum * 20.0, lum)
    alive = torch.arange(p.shape[0], device=p.device) < gpu.meta["light_count"]
    return torch.where(alive, torch.clamp(p, min=1e-6), 0.0)


def _emissive_power(e1, e2, rad) -> torch.Tensor:
    c = tm.cross(e1, e2)
    area = 0.5 * torch.sqrt(torch.sum(c * c, -1))
    return tm.luminance(rad) * area * math.pi


def refresh_pool_power(pool: LightPool, gpu) -> LightPool:
    """Selection power -> pdf/cdf, then the packed table."""
    pa = _analytic_power(gpu)
    pe = _emissive_power(pool.em_e1, pool.em_e2, pool.em_rad)
    A = pa.shape[0]
    alive_e = (torch.arange(pe.shape[0], device=pe.device) + A) < pool.n_total
    p = torch.cat([pa, torch.where(alive_e, torch.clamp(pe, min=1e-8), 0.0)])
    pdf = p / torch.clamp(torch.sum(p), min=1e-20)
    # the CDF is summed on the host: a float cumsum on CUDA may add in
    # another order from run to run, and an ulp at a boundary moves a sample
    # to the next light (set-up only: one copy each way)
    cdf = torch.cumsum(pdf.cpu(), 0).to(pdf.device)
    return pack_pool(pool._replace(power_cdf=cdf, power_pdf=pdf), gpu)


def pack_pool(pool: LightPool, gpu) -> LightPool:
    """Build the one-row-per-light packed table."""
    A = gpu.light_type.shape[0]
    E = pool.em_v0.shape[0]
    dev = pool.em_v0.device
    pa = torch.cat([gpu.light_type.to(torch.float32)[:, None], gpu.light_pos,
                    gpu.light_dir, gpu.light_color, gpu.light_range[:, None],
                    gpu.light_cone, torch.zeros((A, 3), device=dev)], -1)
    pe = torch.cat([torch.zeros((E, 1), device=dev), pool.em_v0, pool.em_e1,
                    pool.em_e2, pool.em_rad, torch.ones((E, 1), device=dev),
                    torch.zeros((E, 2), device=dev)], -1)
    return pool._replace(packed=torch.cat([pa, pe], 0))


def light_incident_rows(rows, uv, pos):
    """Polymorphic light evaluation from packed rows (..., 16) at shading
    points pos (..., 3) with area samples uv (..., 2) -> (L, radiance,
    dist). The emissive radiance folds cos_l * area / d^2."""
    return _rows_incident(rows, uv, pos)[:3]


def _rows_incident(rows, uv, pos):
    """light_incident_rows plus the emissive sample's area-measure geometry
    (is_em, area, cos_l, d2)."""
    is_em = rows[..., 13] > 0.5
    ltype = rows[..., 0].to(torch.int32)
    ldir = rows[..., 4:7]
    cone = rows[..., 11:13]
    # analytic (shading.light_incident with a per-lane type)
    is_dir = ltype == LIGHT_DIRECTIONAL
    to_l = torch.where(is_dir[..., None], -ldir, rows[..., 1:4] - pos)
    dist = torch.sqrt(torch.sum(to_l * to_l, -1, keepdim=True))
    L_a = to_l / torch.clamp(dist, min=1e-8)
    dist = dist[..., 0]
    atten = torch.where(is_dir, 1.0, _range_falloff(dist, rows[..., 10])
                        / torch.clamp(dist * dist, min=1e-4))
    cd = torch.sum(-L_a * ldir, -1)
    spot = torch.clamp((cd - cone[..., 1]) / torch.clamp(cone[..., 0] - cone[..., 1],
                                                          min=1e-4), 0.0, 1.0)
    spot = spot * spot
    atten = torch.where(ltype == LIGHT_SPOT, atten * spot, atten)
    rad_a = rows[..., 7:10] * atten[..., None]
    dist_a = torch.where(is_dir, 1e9, dist)
    # emissive triangle
    u, v = uv[..., 0], uv[..., 1]
    over = (u + v) > 1.0
    uu = torch.where(over, 1.0 - u, u)
    vv = torch.where(over, 1.0 - v, v)
    e1, e2 = rows[..., 4:7], rows[..., 7:10]
    to_e = rows[..., 1:4] + uu[..., None] * e1 + vv[..., None] * e2 - pos
    d2 = torch.clamp(torch.sum(to_e * to_e, -1), min=1e-8)
    dist_e = torch.sqrt(d2)
    L_e = to_e / dist_e[..., None]
    n_x2 = tm.cross(e1, e2)
    area = 0.5 * torch.sqrt(torch.sum(n_x2 * n_x2, -1))
    n_l = n_x2 / torch.clamp(2.0 * area, min=1e-12)[..., None]
    cos_l = torch.abs(torch.sum(n_l * (-L_e), -1))
    rad_e = rows[..., 10:13] * (cos_l * area / d2)[..., None]

    L = torch.where(is_em[..., None], L_e, L_a)
    rad = torch.where(is_em[..., None], rad_e, rad_a)
    return L, rad, torch.where(is_em, dist_e, dist_a), is_em, area, cos_l, d2


def pool_light_incident_packed(pool: LightPool, li, uv, pos):
    """Incident (L, radiance, dist) of pool lights ``li`` at ``pos`` from
    one packed-row gather per lane (see light_incident_rows)."""
    N = pool.packed.shape[0]
    return light_incident_rows(pool.packed[torch.clamp(li, 0, N - 1)], uv, pos)


def pool_light_incident(pool: LightPool, li, uv, pos):
    """Incident (L, radiance, dist) of pool lights ``li`` at ``pos``, plus
    the area-measure geometry of emissive samples, (is_em, area, cos_l, d2):
    the solid-angle pdf of a sampled direction is pdf_select * d2 / (area *
    cos_l) (the path tracer's MIS; lights.py:197 with return_aux=True)."""
    N = pool.packed.shape[0]
    L, rad, dist, is_em, area, cos_l, d2 = _rows_incident(
        pool.packed[torch.clamp(li, 0, N - 1)], uv, pos)
    return L, rad, dist, (is_em, area, cos_l, d2)


def presample_lights(pool: LightPool, frame: int, n_tiles: int = PRESAMPLE_TILES,
                     tile_size: int = PRESAMPLE_TILE_SIZE):
    """Per-frame RIS presampling: (ids (T, S) int64, inv_pdf (T, S) f32),
    ids drawn proportional to power (-1 when the pool is empty)."""
    dev = pool.power_cdf.device
    slot = torch.arange(n_tiles * tile_size, dtype=torch.int64, device=dev)
    bits = pcg3d(torch.stack([slot, torch.full_like(slot, frame),
                              torch.full_like(slot, 7)], -1))
    u = uniform_from_bits(bits[..., 0])
    ids = torch.searchsorted(pool.power_cdf, u)
    ids = torch.clamp(ids, 0, pool.power_pdf.shape[0] - 1)
    inv_pdf = 1.0 / torch.clamp(pool.power_pdf[ids], min=1e-20)
    if pool.n_total <= 0:
        ids = torch.full_like(ids, -1)
    return ids.reshape(n_tiles, tile_size), inv_pdf.reshape(n_tiles, tile_size)


def presample_light_rows(pool: LightPool, frame: int):
    """Presample tiles carrying whole packed rows: (T=64, S=128, 18) f32 =
    [packed row (16), inv_pdf, id]; S is the candidate kernel's segment."""
    ids, inv = presample_lights(pool, frame)
    N = pool.packed.shape[0]
    rows = pool.packed[torch.clamp(ids, 0, N - 1)]
    rows = torch.where((ids >= 0)[..., None], rows, 0.0)
    return torch.cat([rows, inv[..., None], ids.to(torch.float32)[..., None]], -1)
