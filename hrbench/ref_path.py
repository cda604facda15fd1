"""The plain reference of the path tracer's work, one step at a time:
primary rays, one bounce of a lane (closest hit, emission, next-event
estimation over the light pool with its shadow ray, Russian roulette,
transmission, BRDF sampling), the wavefront's capacity roulette between
bounces, the per-pixel mean over samples, the running average and the
tonemap.

This is HobbyRenderer's ReferencePathTracer (``src/shaders/PathTracer.hlsl``)
as the configuration runs it: 8 bounces, Russian roulette from bounce 2,
power-proportional light selection over the analytic lights and the
emissive triangles (at most 16,384, evenly subsampled with their radiance
scaled), MIS against the BRDF sampler for emissive triangles, GGX-VNDF /
cosine BRDF sampling, dielectric transmission with Beer-Lambert media,
MASK and BLEND alpha, stochastic trilinear base-colour texturing, and the
Bruneton sky (``ref_sky.py``) on a miss. Random numbers are pcg3d of
(pixel, sample frame, dimension): sample s of accumulation frame a draws
frame a * spp + s; bounce b uses dimensions 1 + 8b + k.

Plain PyTorch and NumPy; it imports nothing of the program. It works out
the light pool, the textures' mip chains and every hit attribute again
from the scene snapshot (``reference.py``). ``dtype`` runs the shading
arithmetic in a lower precision: the control."""

from __future__ import annotations

import math

import numpy as np
import torch

from hrbench import ref_sky, reference

MIN_ROUGHNESS = 0.03
DIELECTRIC_F0 = 0.04
INF_T = 3.0e38            # the distance a miss carries (finite)
MAX_EMISSIVE_TRIS = 16384
T_MIN = 1e-4
SUN_DIST = 1e9            # a directional light's distance


# ---------------------------------------------------------------------------
# random numbers: pcg3d on uint32 words held in int64
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF


def _mul(a, b):
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & M32


def pcg3d(x, y, z):
    v = [(_mul(w & M32, 1664525) + 1013904223) & M32 for w in (x, y, z)]
    x, y, z = v
    x = (x + _mul(y, z)) & M32
    y = (y + _mul(z, x)) & M32
    z = (z + _mul(x, y)) & M32
    x, y, z = x ^ (x >> 16), y ^ (y >> 16), z ^ (z >> 16)
    x = (x + _mul(y, z)) & M32
    y = (y + _mul(z, x)) & M32
    z = (z + _mul(x, y)) & M32
    return x, y, z


def rand3(pix, frame, dim: int):
    """Three uniforms in [0, 1) (float32) of (pixel, frame, dimension)."""
    bits = pcg3d(pix, frame, torch.full_like(pix, dim))
    return tuple(b.to(torch.float32) * 2.3283064365386963e-10 for b in bits)


def rand_bits(pix, frame, dim: int):
    return pcg3d(pix, frame, torch.full_like(pix, dim))


# ---------------------------------------------------------------------------
# vector helpers, sampling, BRDF
# ---------------------------------------------------------------------------

def _dot(a, b):
    return torch.sum(a * b, -1)


def _norm(v):
    return v / torch.clamp(torch.sqrt(_dot(v, v))[..., None], min=1e-20)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _lum(c):
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722


def _onb(n):
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + s * n[..., 0] * n[..., 0] * a, s * b, -s * n[..., 0]], -1)
    bt = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], -1)
    return t, bt


def _to_world(n, v):
    t, b = _onb(n)
    return t * v[..., 0:1] + b * v[..., 1:2] + n * v[..., 2:3]


def _to_local(n, v):
    t, b = _onb(n)
    return torch.stack([_dot(v, t), _dot(v, b), _dot(v, n)], -1)


def _ggx_vndf(v, alpha, u1, u2):
    vh = _norm(torch.stack([alpha * v[..., 0], alpha * v[..., 1], v[..., 2]], -1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-12))
    zero = torch.zeros_like(inv)
    t1 = torch.where(lensq[..., None] > 1e-9,
                     torch.stack([-vh[..., 1], vh[..., 0], zero], -1) * inv[..., None],
                     torch.stack([zero + 1.0, zero, zero], -1))
    t2 = _cross(vh, t1)
    r = torch.sqrt(u1)
    phi = (2.0 * math.pi) * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    return _norm(torch.stack([alpha * nh[..., 0], alpha * nh[..., 1],
                              torch.clamp(nh[..., 2], min=0.0)], -1))


def _g1(ndx, alpha):
    a2 = alpha * alpha
    return 2.0 * ndx / torch.clamp(ndx + torch.sqrt(a2 + (1.0 - a2) * ndx * ndx), min=1e-8)


def _g2_over_g1(ndv, ndl, alpha):
    g1v, g1l = _g1(ndv, alpha), _g1(ndl, alpha)
    return g1l * g1v / torch.clamp(g1v + g1l - g1v * g1l, min=1e-8)


def _cone(axis, cos_max, u1, u2):
    cos_t = 1.0 - u1 * (1.0 - cos_max)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = (2.0 * math.pi) * u2
    return _to_world(axis, torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                                        cos_t], -1))


def _cosine(u1, u2):
    r = torch.sqrt(u1)
    phi = (2.0 * math.pi) * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                        torch.sqrt(torch.clamp(1.0 - u1, min=0.0))], -1)


def _power(a, b):
    return a * a / torch.clamp(a * a + b * b, min=1e-12)


def _mix_pdf(v, l, alpha, p_spec):
    """Solid-angle pdf of the diffuse / GGX-VNDF mixture at l (local)."""
    ndl = torch.clamp(l[..., 2], min=0.0)
    ndv = torch.clamp(v[..., 2], min=1e-5)
    ndh = torch.clamp(_norm(v + l)[..., 2], min=0.0)
    a2 = alpha * alpha
    dd = ndh * ndh * (a2 - 1.0) + 1.0
    D = a2 / torch.clamp(math.pi * dd * dd, min=1e-12)
    return p_spec * (_g1(ndv, alpha) * D / (4.0 * ndv)) + (1.0 - p_spec) * (ndl / math.pi)


def _schlick(vdh, f0):
    return f0 + (1.0 - f0) * torch.pow(torch.clamp(1.0 - vdh, 0.0, 1.0), 5.0)


def _brdf_params(albedo, metallic, rough):
    rough = torch.clamp(rough, MIN_ROUGHNESS, 1.0)
    diffuse = albedo * (1.0 - metallic[..., None])
    f0 = DIELECTRIC_F0 * (1.0 - metallic[..., None]) + albedo * metallic[..., None]
    return diffuse, f0, rough * rough


def _eval_brdf(n, v, l, albedo, metallic, rough):
    """GGX specular + Lambert (energy-split by Fresnel), times n.l."""
    diffuse, f0, alpha = _brdf_params(albedo, metallic, rough)
    h = _norm(v + l)
    ndl = torch.clamp(_dot(n, l), min=0.0)
    ndv = torch.clamp(_dot(n, v), min=1e-5)
    ndh = torch.clamp(_dot(n, h), min=0.0)
    vdh = torch.clamp(_dot(v, h), min=0.0)
    F = _schlick(vdh[..., None], f0)
    a2 = alpha * alpha
    dd = ndh * ndh * (a2 - 1.0) + 1.0
    D = a2 / torch.clamp(math.pi * dd * dd, min=1e-8)
    gv = ndl * torch.sqrt(torch.clamp(ndv * ndv * (1 - a2) + a2, min=1e-8))
    gl = ndv * torch.sqrt(torch.clamp(ndl * ndl * (1 - a2) + a2, min=1e-8))
    Vis = 0.5 / torch.clamp(gv + gl, min=1e-8)
    return ((1.0 - F) * diffuse / math.pi + (D * Vis)[..., None] * F) * ndl[..., None]


def _fresnel_dielectric(cos_i, eta):
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = (1.0 / (eta * eta)) * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    rs = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=1e-8)
    rp = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-8)
    return torch.where(sin2_t >= 1.0, 1.0, 0.5 * (rs * rs + rp * rp))


def _refract(d, n, eta_rel):
    cos_i = -_dot(d, n)[..., None]
    sin2_t = eta_rel * eta_rel * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    return torch.where(tir, d + 2.0 * cos_i * n, eta_rel * d + (eta_rel * cos_i - cos_t) * n), \
        tir[..., 0]


def _offset(p, n, d):
    side = torch.where(_dot(n, d)[..., None] >= 0, 1.0, -1.0).to(p.dtype)
    scale = torch.clamp(torch.amax(torch.abs(p), -1, keepdim=True), min=1.0)
    return p + n * side * (4e-4 * scale)


def _retarget(p, o, L, dist):
    """A shadow ray from the offset origin o through p + L dist, stopping
    short of it: (direction, t_max)."""
    dist_c = torch.where(torch.isfinite(dist), dist, 1.0)
    to_t = p + L * dist_c[..., None] - o
    dist_o = torch.sqrt(_dot(to_t, to_t))
    L_o = to_t / torch.clamp(dist_o, min=1e-8)[..., None]
    L_o = torch.where(torch.isfinite(L_o), L_o, 0.0)
    scale = torch.clamp(torch.amax(torch.abs(p), -1), min=1.0)
    eps = torch.clamp(1.6e-3 * scale, min=2e-3)
    return L_o, torch.where(torch.isfinite(dist), dist_o - eps, dist)


# ---------------------------------------------------------------------------
# the world the reference shades
# ---------------------------------------------------------------------------

def _mip_chain(img: np.ndarray) -> list:
    """A power-of-two RGBA image's box-filtered mip chain down to 1x1, each
    level rounded to uint8 from the unrounded level above."""
    x = img.astype(np.float32)
    out = [x]
    while x.shape[0] > 1:
        s = x.shape[0] // 2
        x = x.reshape(s, 2, s, 2, x.shape[-1]).mean((1, 3))
        out.append(x)
    return [np.clip(np.round(lv), 0, 255).astype(np.uint8) for lv in out]


snapshot = reference.snapshot_scene


class World:
    """Everything the reference shades against, from the snapshot: the
    triangles and their attributes, materials, texel chains, the light pool
    and the sky's settings. ``scene_time`` is ignored: the scenes this
    reference covers are static (``snapshot`` refuses an animated one)."""

    def __init__(self, snap: dict, settings: dict, device, scene_time: float = 0.0):
        dev = torch.device(device)
        self.device = dev
        self.settings = settings
        self.tris = reference.world_triangles(snap, dev)
        attrs = reference.triangle_attributes(snap, dev)
        self.tri_inst, self.vn, self.vuv = attrs["inst"], attrs["vn"], attrs["vuv"]
        insts = snap["instances"]
        self.inst_mat = torch.as_tensor([i["material"] for i in insts], device=dev)
        self.inst_alpha = torch.as_tensor([i["alpha_mode"] for i in insts], device=dev)
        mats = snap["materials"]

        def col(key, shape=()):
            return torch.as_tensor(np.asarray([np.broadcast_to(m[key], shape) for m in mats],
                                              np.float32), device=dev)
        self.m_base = col("base", (4,))
        self.m_metal, self.m_rough = col("metallic"), col("roughness")
        self.m_emis = col("emissive", (3,))
        self.m_cutoff, self.m_trans, self.m_ior = (col("alpha_cutoff"), col("transmission"),
                                                   col("ior"))
        self.m_atten_c, self.m_atten_d = col("atten_color", (3,)), col("atten_dist")
        self.m_uv_scale = col("uv_scale")
        # texel chains: level l of material m at rows tex_off[m, l], S >> l wide
        self.textured = any(m["image"] is not None for m in mats)
        rows, offs, sizes = [], np.zeros((len(mats), 16), np.int64), np.ones(len(mats), np.int64)
        cur = 0
        for mi, m in enumerate(mats):
            if m["image"] is None:
                continue
            img = m["image"]
            if img.shape[0] != img.shape[1] or img.shape[0] & (img.shape[0] - 1) \
                    or img.shape[0] < 4 or img.shape[2] != 4:
                raise ValueError("the reference samples square power-of-two RGBA images")
            chain = _mip_chain(img)
            sizes[mi] = img.shape[0]
            for li in range(16):
                lv = chain[min(li, len(chain) - 1)]
                offs[mi, li] = cur
                if li < len(chain):
                    rows.append(lv.reshape(-1, 4))
                    cur += lv.shape[0] * lv.shape[1]
                else:
                    offs[mi, li] = offs[mi, len(chain) - 1]
        self.texels = torch.as_tensor(np.concatenate(rows) if rows
                                      else np.zeros((1, 4), np.uint8), device=dev)
        self.tex_off = torch.as_tensor(offs, device=dev)
        self.tex_size = torch.as_tensor(sizes, device=dev)
        self.has_tex = torch.as_tensor([m["image"] is not None for m in mats], device=dev)
        self._light_pool(snap)

    def _light_pool(self, snap):
        """Analytic lights, then the emissive triangles (LOD0, world
        space, instance order), power-proportional selection."""
        dev = self.device
        lights = snap["lights"][:64]
        self.n_analytic = len(lights)
        kinds = np.asarray([li["type"] for li in lights], np.int64)
        dirs = np.stack([li["dir"] / max(np.linalg.norm(li["dir"].astype(np.float64)), 1e-20)
                         for li in lights]).astype(np.float32) if lights else np.zeros((0, 3))
        color = np.stack([li["color"] for li in lights]).astype(np.float32) if lights \
            else np.zeros((0, 3), np.float32)
        self.l_kind = torch.as_tensor(kinds, device=dev)
        self.l_pos = torch.as_tensor(np.stack([li["pos"] for li in lights]), device=dev)
        self.l_dir = torch.as_tensor(dirs, device=dev)
        self.l_color = torch.as_tensor(color, device=dev)
        self.l_range = torch.as_tensor([li["range"] for li in lights], dtype=torch.float32,
                                       device=dev)
        self.l_cone = torch.as_tensor([li["cone"] for li in lights], dtype=torch.float32,
                                      device=dev)
        sun = [i for i, li in enumerate(lights) if li["type"] == reference.LIGHT_DIRECTIONAL]
        self.sun_dir = self.l_dir[sun[0] if sun else 0]
        # emissive triangles
        mats = snap["materials"]
        tri_mat = self.inst_mat[self.tri_inst]
        emis = self.m_emis[tri_mat]
        em_tri = torch.nonzero((emis > 0).any(-1)).reshape(-1)
        E = int(em_tri.shape[0])
        rad = emis[em_tri]
        if E > MAX_EMISSIVE_TRIS:
            keep = torch.as_tensor(np.linspace(0, E - 1, MAX_EMISSIVE_TRIS).astype(np.int64),
                                   device=dev)
            em_tri = em_tri[keep]
            rad = rad[keep] * (E / MAX_EMISSIVE_TRIS)
        tv = self.tris[em_tri]
        self.em_v0, self.em_e1, self.em_e2 = tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]
        self.em_rad = rad
        self.em_index = torch.full((self.tris.shape[0],), -1, dtype=torch.int64, device=dev)
        self.em_index[em_tri] = torch.arange(em_tri.shape[0], device=dev)
        del mats
        # selection power: luminance (x20 for a directional light); emitters
        # luminance x area x pi
        lum = _lum(self.l_color)
        pa = torch.clamp(torch.where(self.l_kind == reference.LIGHT_DIRECTIONAL, lum * 20.0,
                                     lum), min=1e-6)
        c = _cross(self.em_e1, self.em_e2)
        pe = torch.clamp(_lum(self.em_rad) * (0.5 * torch.sqrt(_dot(c, c))) * math.pi,
                         min=1e-8)
        p = torch.cat([pa, pe])
        self.pdf = p / torch.clamp(p.sum(), min=1e-20)
        self.cdf = torch.cumsum(self.pdf.cpu(), 0).to(dev)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def _halton(i: int, base: int) -> float:
    f, r = 1.0, 0.0
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


def primary_dirs(world_up, pos, target, fov_y: float, width: int, height: int,
                 frame_index: int, pix, ju, jv):
    """Unit directions (R, 3) of primary rays through pixel ``pix`` at the
    sub-pixel offset (ju, jv) in [0, 1), with the camera's per-frame
    Halton(2, 3) offset of frame ``frame_index``."""
    dev = pix.device
    pos = np.asarray(pos, np.float64)
    fwd = np.asarray(target, np.float64) - pos
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, world_up)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    i = frame_index % 16 + 1
    jx, jy = _halton(i, 2) - 0.5, _halton(i, 3) - 0.5
    f = 1.0 / math.tan(0.5 * fov_y)
    aspect = width / height
    x = (pix % width).to(torch.float64) + ju.to(torch.float64)
    y = (pix // width).to(torch.float64) + jv.to(torch.float64)
    X = (x / width * 2.0 - 1.0 + 2.0 * jx / width) * aspect / f
    Y = (1.0 - y / height * 2.0 - 2.0 * jy / height) / f
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    d = t(right) * X[:, None] + t(up) * Y[:, None] + t(fwd)
    return (d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)).to(torch.float32)


def _texture(W: World, mat, uv, t_hit, bits, proj11: float, height: int, dt):
    """Stochastic trilinear base-colour fetch: (albedo factor (N, 3), alpha
    factor (N,)); 1 for untextured materials."""
    u0, u1, u2 = (b.to(torch.float32) * 2.3283064365386963e-10 for b in bits)
    S = W.tex_size[mat]
    uv_s = uv * torch.clamp(W.m_uv_scale[mat], min=1e-6)[:, None].to(dt)
    spread = 2.0 / (proj11 * height)
    foot = torch.where(torch.isfinite(t_hit), t_hit, 1.0) * spread
    lod = torch.log2(torch.clamp(S.to(dt) * foot, min=1e-6))
    max_l = torch.round(torch.log2(S.to(torch.float32))).to(torch.int64)
    lvl = torch.minimum(torch.clamp(torch.floor(lod + u0.to(dt)).to(torch.int64), min=0), max_l)
    Sl = torch.clamp(S >> lvl, min=1)
    xi = torch.floor(uv_s[:, 0] * Sl.to(dt) - 0.5 + u1.to(dt)).to(torch.int64) % Sl
    yi = torch.floor(uv_s[:, 1] * Sl.to(dt) - 0.5 + u2.to(dt)).to(torch.int64) % Sl
    off = W.tex_off[mat, torch.clamp(lvl, max=15)]
    texel = W.texels[torch.clamp(off + yi * Sl + xi, 0, W.texels.shape[0] - 1)].to(dt) / 255.0
    albedo = torch.where(W.has_tex[mat][:, None], torch.pow(texel[:, :3], 2.2), 1.0)
    alpha = torch.where(W.has_tex[mat], texel[:, 3], 1.0)
    return albedo.to(dt), alpha.to(dt)


def _light_incident(W: World, s, u1, u2, pos, dt):
    """Incident (L, radiance, dist, is_emissive, area, cos_l, d2) of pool
    entries s at pos."""
    A = W.n_analytic
    is_em = s >= A
    a = torch.clamp(s, max=max(A - 1, 0))
    e = torch.clamp(s - A, min=0)
    kind = W.l_kind[a]
    is_dir = kind == reference.LIGHT_DIRECTIONAL
    ldir = W.l_dir[a].to(dt)
    to_l = torch.where(is_dir[:, None], -ldir, W.l_pos[a].to(dt) - pos)
    dist = torch.sqrt(_dot(to_l, to_l))
    L_a = to_l / torch.clamp(dist, min=1e-8)[:, None]
    x = torch.clamp(dist / torch.clamp(W.l_range[a].to(dt), min=1e-4), 0.0, 1.0)
    fall = torch.clamp((1.0 - x ** 4) ** 2, 0.0, 1.0)
    atten = torch.where(is_dir, 1.0, fall / torch.clamp(dist * dist, min=1e-4))
    cone = W.l_cone[a].to(dt)
    cd = _dot(-L_a, ldir)
    spot = torch.clamp((cd - cone[:, 1]) / torch.clamp(cone[:, 0] - cone[:, 1], min=1e-4),
                       0.0, 1.0) ** 2
    atten = torch.where(kind == reference.LIGHT_SPOT, atten * spot, atten)
    rad_a = W.l_color[a].to(dt) * atten[:, None]
    dist_a = torch.where(is_dir, SUN_DIST, dist)
    # an emissive triangle: a uniform point, the radiance folding cos_l area / d^2
    over = (u1 + u2) > 1.0
    uu, vv = torch.where(over, 1.0 - u1, u1), torch.where(over, 1.0 - u2, u2)
    e1, e2 = W.em_e1[e].to(dt), W.em_e2[e].to(dt)
    to_e = W.em_v0[e].to(dt) + uu[:, None] * e1 + vv[:, None] * e2 - pos
    d2 = torch.clamp(_dot(to_e, to_e), min=1e-8)
    dist_e = torch.sqrt(d2)
    L_e = to_e / dist_e[:, None]
    nx2 = _cross(e1, e2)
    area = 0.5 * torch.sqrt(_dot(nx2, nx2))
    n_l = nx2 / torch.clamp(2.0 * area, min=1e-12)[:, None]
    cos_l = torch.abs(_dot(n_l, -L_e))
    rad_e = W.em_rad[e].to(dt) * (cos_l * area / d2)[:, None]
    return (torch.where(is_em[:, None], L_e, L_a), torch.where(is_em[:, None], rad_e, rad_a),
            torch.where(is_em, dist_e, dist_a), is_em, is_dir & ~is_em, area, cos_l, d2)


def bounce(W: World, lanes: dict, b: int, hit, proj11: float, height: int, rr_start: int,
           dtype=torch.float32):
    """One bounce of live lanes: ``lanes`` holds their state as it came in
    (o, d, radiance, throughput, inside, sigma_t, prev_pdf; pix, frame),
    ``hit`` the reference's (t, tri, u, v) of their closest-hit rays. ->
    (the state after the bounce (o, d, radiance, throughput, active,
    inside, sigma_t, prev_pdf), the shadow rays (o, d, t_max, live)), the
    shadow test still to come: ``finish`` adds NEE's contribution once the
    shadow rays are answered."""
    dt = dtype
    f = lambda x: x.to(dt)  # noqa: E731
    st = W.settings
    o, d = f(lanes["o"]), f(lanes["d"])
    radiance, throughput = f(lanes["radiance"]), f(lanes["throughput"])
    inside, sigma_t, prev_pdf = lanes["inside"], f(lanes["sigma_t"]), f(lanes["prev_pdf"])
    pix, frame = lanes["pix"], lanes["frame"]
    dim = 1 + b * 8
    t_hit, tri, hu, hv = hit
    miss = tri < 0
    t_hit = torch.where(miss, INF_T, t_hit)
    throughput = throughput * torch.where(inside[:, None], torch.exp(-sigma_t * f(t_hit)[:, None]),
                                          1.0)
    sky = ref_sky.sky_radiance(d, W.sun_dir, st, with_sun_disk=b == 0)
    radiance = radiance + torch.where(miss[:, None], throughput * sky, 0.0)
    active = ~miss

    tc = torch.clamp(tri, min=0)
    hu, hv = f(hu), f(hv)
    bary = torch.stack([1.0 - hu - hv, hu, hv], -1)
    n = _norm(torch.einsum("rv,rvi->ri", bary, f(W.vn[tc])))
    tv = f(W.tris[tc])
    gn = _norm(_cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]))
    pos = o + d * f(t_hit)[:, None]
    uv = torch.einsum("rv,rvi->ri", bary, f(W.vuv[tc]))
    inst = W.tri_inst[tc]
    mat = W.inst_mat[inst]
    gn = torch.where(_dot(gn, d)[:, None] > 0, -gn, gn)
    n = torch.where(_dot(n, gn)[:, None] < 0, -n, n)

    albedo = f(W.m_base[mat, :3])
    alpha_v = f(W.m_base[mat, 3])
    metallic = f(W.m_metal[mat])
    rough = torch.clamp(f(W.m_rough[mat]), MIN_ROUGHNESS, 1.0)
    emissive = f(W.m_emis[mat])
    trans = f(W.m_trans[mat])
    if W.textured:
        ta, tal = _texture(W, mat, uv, f(t_hit), rand_bits(pix, frame, dim + 5), proj11,
                           height, dt)
        albedo = albedo * ta
        alpha_v = alpha_v * tal

    alpha_fail = active & (alpha_v < f(W.m_cutoff[mat]))
    u_cov = f(rand3(pix, frame, dim + 6)[0])
    blend = W.inst_alpha[inst] == reference.ALPHA_BLEND
    alpha_fail = alpha_fail | (active & blend & (u_cov >= torch.maximum(alpha_v, trans)))
    shade_ok = active & ~alpha_fail

    v = -d
    ior = torch.clamp(f(W.m_ior[mat]), min=1.01)
    atten_c = torch.clamp(f(W.m_atten_c[mat]), 1e-4, 1.0)
    atten_d = torch.clamp(f(W.m_atten_d[mat]), min=1e-3)
    cos_i = torch.clamp(_dot(v, n), min=0.0)
    F_d = _fresnel_dielectric(cos_i, torch.where(inside, 1.0 / ior, ior))
    p_transmit = torch.clamp(trans * (1.0 - F_d), 0.0, 0.98)
    diffuse_c, f0, alpha = _brdf_params(albedo, metallic, rough)
    diffuse_c = diffuse_c * (1.0 - trans)[:, None]
    w_spec = _lum(f0) + 1e-4
    w_diff = _lum(diffuse_c) + 1e-4
    p_spec = w_spec / (w_spec + w_diff)
    v_loc = _to_local(n, v)
    v_loc = torch.cat([v_loc[:, :2], torch.clamp(v_loc[:, 2:3], min=1e-4)], -1)

    # emission at the hit, MIS-weighted against NEE for the pool's emitters
    e_idx = W.em_index[tc]
    in_pool = shade_ok & (e_idx >= 0) & (prev_pdf > 0.0)
    e_c = torch.clamp(e_idx, min=0)
    nx2 = _cross(f(W.em_e1[e_c]), f(W.em_e2[e_c]))
    area_h = 0.5 * torch.linalg.vector_norm(nx2, dim=-1)
    n_eh = nx2 / torch.clamp(2.0 * area_h, min=1e-12)[:, None]
    cos_lh = torch.abs(_dot(n_eh, -d))
    d2h = torch.clamp(f(t_hit) * f(t_hit), min=1e-8)
    pdf_h = f(W.pdf[W.n_analytic + e_c]) * d2h / torch.clamp(area_h * cos_lh, min=1e-8)
    em_out = torch.where(in_pool[:, None], f(W.em_rad[e_c]) * _power(prev_pdf, pdf_h)[:, None],
                         emissive)
    radiance = radiance + torch.where(shade_ok[:, None], throughput * em_out, 0.0)

    # next-event estimation
    u_l, u1, u2 = rand3(pix, frame, dim)
    n_src = W.pdf.shape[0]
    s = torch.clamp(torch.searchsorted(W.cdf, u_l), 0, n_src - 1)
    pdf_sel = torch.clamp(f(W.pdf[s]), min=1e-12)
    u1, u2 = f(u1), f(u2)
    L, rad, dist, is_em, is_sun, area_s, cos_ls, d2s = _light_incident(W, s, u1, u2, pos, dt)
    cos_max = float(np.cos(np.float32(st["sun_angular_radius"])))
    L = torch.where(is_sun[:, None], _cone(L, cos_max, u1, u2), L)
    pdf_sol = pdf_sel * d2s / torch.clamp(area_s * cos_ls, min=1e-8)
    pdf_b = (1.0 - p_transmit) * _mix_pdf(v_loc, _to_local(n, L), alpha, p_spec)
    w_nee = torch.where(is_em, _power(pdf_sol, pdf_b), 1.0)
    fr = _eval_brdf(n, v, L, albedo * (1.0 - trans)[:, None], metallic, rough)
    nee_live = shade_ok & (_dot(L, gn) > 0) & (_dot(L, n) > 0) & (torch.amax(rad, -1) > 0)
    so = _offset(pos, gn, L)
    L_v, t_max = _retarget(pos, so, L, dist)
    nee = torch.where(nee_live[:, None], throughput * fr * rad * (w_nee / pdf_sel)[:, None],
                      0.0)

    # Russian roulette
    u_rr = f(rand3(pix, frame, dim + 1)[0])
    p_cont = torch.clamp(torch.amax(throughput, -1), 0.05, 0.95) if b >= rr_start \
        else torch.ones_like(u_rr)
    active = active & (u_rr < p_cont)
    throughput = throughput / p_cont[:, None]

    # transmission
    u_t = f(rand3(pix, frame, dim + 4)[0])
    do_tr = shade_ok & (u_t < p_transmit)
    d_refr, tir = _refract(d, n, torch.where(inside, ior, 1.0 / ior)[:, None])
    new_inside = torch.where(do_tr & ~tir, ~inside, inside)
    sigma_t = torch.where((do_tr & new_inside & ~inside)[:, None],
                          -torch.log(atten_c) / atten_d[:, None], sigma_t)
    inside = new_inside

    # BRDF sampling
    u_sel, us1, _ = (f(x) for x in rand3(pix, frame, dim + 2))
    ud1, ud2, _ = (f(x) for x in rand3(pix, frame, dim + 3))
    h_loc = _ggx_vndf(v_loc, alpha, us1, ud2)
    l_spec = _norm(2.0 * _dot(v_loc, h_loc)[:, None] * h_loc - v_loc)
    spec = u_sel < p_spec
    l_loc = torch.where(spec[:, None], l_spec, _cosine(ud1, ud2))
    ndl = l_loc[:, 2]
    F = _schlick(torch.clamp(_dot(v_loc, h_loc), min=0.0)[:, None], f0)
    w_s = F * _g2_over_g1(v_loc[:, 2], torch.clamp(ndl, min=1e-5), alpha)[:, None]
    weight = torch.where(spec[:, None], w_s / torch.clamp(p_spec, min=1e-4)[:, None],
                         diffuse_c / torch.clamp(1 - p_spec, min=1e-4)[:, None])
    weight = weight / torch.clamp(1.0 - p_transmit, min=0.02)[:, None]
    ok = (ndl > 1e-5) | do_tr | alpha_fail
    active = active & ok
    weight = torch.where(do_tr[:, None], albedo, weight)
    weight = torch.where(alpha_fail[:, None], 1.0, weight)
    throughput = torch.clamp(throughput * torch.where(ok[:, None], weight, 0.0), max=64.0)
    d_new = torch.where(do_tr[:, None], d_refr, _to_world(n, l_loc))
    d_new = torch.where(alpha_fail[:, None], d, d_new)
    o_new = torch.where(alpha_fail[:, None], _offset(pos, -gn, d_new), _offset(pos, gn, d_new))
    pdf_next = (1.0 - p_transmit) * _mix_pdf(v_loc, _to_local(n, d_new), alpha, p_spec)
    prev_pdf = torch.where(do_tr | alpha_fail | ~shade_ok, 0.0, pdf_next)
    out = dict(o=o_new, d=d_new, radiance=radiance, throughput=throughput, active=active,
               inside=inside, sigma_t=sigma_t, prev_pdf=prev_pdf, nee=nee)
    return out, dict(o=so.to(torch.float32), d=L_v.to(torch.float32),
                     t_max=t_max.to(torch.float32), live=nee_live)


def finish(out: dict, occluded) -> dict:
    """NEE's contribution added where the shadow ray reached the light."""
    res = dict(out)
    nee = res.pop("nee")
    res["radiance"] = res["radiance"] + torch.where(occluded[:, None], 0.0, nee)
    return {k: (v.to(torch.float32) if v.is_floating_point() else v) for k, v in res.items()}


def capacity_keep(pix, frame, b: int, cap: int, n_live: int):
    """(u_c (N,), p_keep): the roulette that decides which live lanes enter
    a compacted wavefront of ``cap`` slots before bounce ``b``, unbiased by
    1 / p_keep."""
    u_c = rand3(pix, frame, 1 + (b - 1) * 8 + 7)[0]
    p_keep = min(float(np.float32(0.8) * np.float32(cap) / np.float32(max(n_live, 1))), 1.0)
    return u_c, p_keep


def tonemap(hdr, exposure):
    """Exposure, Khronos PBR Neutral, sRGB, uint8."""
    c = hdr * exposure
    x = torch.minimum(c[..., 0], torch.minimum(c[..., 1], c[..., 2]))
    c = c - torch.where(x < 0.08, x - 6.25 * x * x, 0.04)[..., None]
    peak = torch.maximum(c[..., 0], torch.maximum(c[..., 1], c[..., 2]))
    start, desat = 0.8 - 0.04, 0.15
    dd = 1.0 - start
    new_peak = 1.0 - dd * dd / (peak + dd - start)
    scale = torch.where(peak < start, 1.0, new_peak / torch.clamp(peak, min=1e-6))
    g = torch.where(peak < start, 0.0, 1.0 - 1.0 / (desat * (peak - new_peak) + 1.0))
    c = torch.clamp(c * scale[..., None] * (1.0 - g[..., None]) + new_peak[..., None]
                    * g[..., None], 0.0, 1.0)
    c = torch.where(c <= 0.0031308, 12.92 * c, 1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)
    return (torch.clamp(c, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
