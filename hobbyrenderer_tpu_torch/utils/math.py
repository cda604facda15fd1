"""Math + quantization utilities.

Covers the reference's math helpers (src/Utilities.{h,cpp}: Halton, pow2 helpers, matrix
helpers), the camera matrix stack (src/Camera.cpp: reversed-Z infinite-far perspective),
vertex quantization (src/SceneLoader.cpp:1946-1974: f32x3 position + octahedral-encoded
normal with bitangent sign + half2 UV + octahedral tangent) and the culling math
(src/shaders/Culling.hlsli:29-85: frustum plane tests, sphere→screen AABB projection).

Every function is written against an array-module parameter ``xp`` (numpy or jax.numpy)
so the host cooker (numpy) and device kernels (jnp, traced under jit) share one
implementation — the TPU build's replacement for the reference's duplicated
C++/HLSL math.

Conventions (fresh TPU-first design; NOT the reference's left-handed D3D conventions):
- Right-handed world/view space, +Y up, camera looks down -Z in view space.
- Column-vector matrices: ``clip = P @ V @ M @ [p, 1]``.
- Reversed-Z: depth 1.0 at the near plane, 0.0 at infinity (better f32 distribution).
- NDC: x,y in [-1,1], z in [0,1]; screen pixel (0,0) is top-left.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Matrices (host-side, numpy float32; uploaded as uniforms)
# ---------------------------------------------------------------------------


def normalize(v, xp=np, eps=1e-20):
    n = xp.sqrt(xp.sum(v * v, axis=-1, keepdims=True))
    return v / xp.maximum(n, eps)


def perspective_reversed_z_infinite(fovy_radians: float, aspect: float, near: float) -> np.ndarray:
    """Reversed-Z, infinite-far projection (reference: src/Camera.cpp reversed-Z).

    Maps view-space z=-near to depth 1 and z=-inf to depth 0.
    """
    f = 1.0 / np.tan(0.5 * fovy_radians)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    # z_clip = near, w_clip = -z_view  => depth = near / -z_view
    m[2, 3] = near
    m[3, 2] = -1.0
    return m


def look_at(eye, center, up) -> np.ndarray:
    eye = np.asarray(eye, np.float64)
    fwd = normalize(np.asarray(center, np.float64) - eye)
    right = normalize(np.cross(fwd, np.asarray(up, np.float64)))
    u = np.cross(right, fwd)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = right
    m[1, :3] = u
    m[2, :3] = -fwd
    m[:3, 3] = -(m[:3, :3] @ eye)
    return m.astype(np.float32)


def ortho(l, r, b, t, n, f) -> np.ndarray:
    """Orthographic projection with reversed-Z depth in [0,1] (CSM cascades)."""
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = 2.0 / (r - l)
    m[1, 1] = 2.0 / (t - b)
    # view z in [-f,-n] -> depth: z=-n => 1, z=-f => 0   (reversed)
    m[2, 2] = 1.0 / (f - n)
    m[2, 3] = f / (f - n)
    m[0, 3] = -(r + l) / (r - l)
    m[1, 3] = -(t + b) / (t - b)
    return m


def quat_to_mat3(q, xp=np):
    """Quaternion (x,y,z,w, glTF order) to 3x3 rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = xp.stack([
        xp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
        xp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
        xp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
    ], axis=-2)
    return m


def compose_trs(t, r, s, xp=np):
    """Compose a 4x4 from translation (3,), rotation quat (4,), scale (3,)."""
    m3 = quat_to_mat3(xp.asarray(r, dtype=np.float32) if xp is np else xp.asarray(r), xp=xp)
    m3 = m3 * xp.asarray(s)[..., None, :]
    if xp is np:
        out = np.eye(4, dtype=np.float32)
        out[:3, :3] = m3
        out[:3, 3] = t
        return out
    out = xp.eye(4, dtype=xp.float32)
    out = out.at[:3, :3].set(m3).at[:3, 3].set(xp.asarray(t))
    return out


def transform_points(m, pts, xp=np):
    """Apply 4x4 ``m`` to (..., 3) points."""
    p = pts @ xp.swapaxes(m[:3, :3], -1, -2) + m[:3, 3]
    return p


def transform_dirs(m, dirs, xp=np):
    return dirs @ xp.swapaxes(m[:3, :3], -1, -2)


def project_to_screen(viewproj, pts, width, height, xp=np, eps=1e-8):
    """World points -> (screen_xy, depth, w). Screen origin top-left, y down."""
    ph = pts @ xp.swapaxes(viewproj[:3, :3], -1, -2) + viewproj[:3, 3]
    w = pts @ viewproj[3, :3] + viewproj[3, 3]
    w_safe = xp.where(xp.abs(w) < eps, xp.where(w < 0, -eps, eps), w)
    ndc = ph / w_safe[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * width
    sy = (0.5 - ndc[..., 1] * 0.5) * height
    return xp.stack([sx, sy], axis=-1), ndc[..., 2], w


# ---------------------------------------------------------------------------
# Frustum culling (reference: src/shaders/Culling.hlsli + GPUCulling.hlsl)
# ---------------------------------------------------------------------------


def extract_frustum_planes(viewproj, xp=np):
    """6 planes (nx,ny,nz,d) with inward normals: dot(n,p)+d >= 0 inside.

    Gribb-Hartmann extraction from a column-vector clip matrix; reversed-Z
    infinite-far has no far plane — we emit 5 real planes + a never-culling
    far plane so the output is fixed-shape (6,4).
    """
    m = viewproj
    rows = [m[3] + m[0],            # left
            m[3] - m[0],            # right
            m[3] + m[1],            # bottom
            m[3] - m[1],            # top
            m[2],                   # near (reversed-Z: z_clip >= 0)
            None]                   # far: none (infinite)
    planes = []
    for r in rows:
        if r is None:
            planes.append(xp.asarray([0.0, 0.0, 0.0, 1.0], dtype=m.dtype))
            continue
        n = r[:3]
        ln = xp.sqrt(xp.sum(n * n))
        planes.append(r / xp.maximum(ln, 1e-20))
    return xp.stack(planes)


def sphere_in_frustum(planes, centers, radii, xp=np):
    """Vectorized sphere-vs-frustum: True if (possibly) visible.

    centers (...,3), radii (...). Reference: frustum sphere test in
    src/shaders/GPUCulling.hlsl:45-60.
    """
    d = centers @ xp.swapaxes(planes[:, :3], -1, -2) + planes[:, 3]  # (..., 6)
    return xp.all(d >= -radii[..., None], axis=-1)


def sphere_screen_extent(center_view, radius, proj00, proj11, znear, xp=np):
    """Conservative NDC AABB of a view-space sphere (for HZB occlusion tests).

    Port of the Mara/McGuire-style bounds used by the reference
    (src/shaders/Culling.hlsli:29-59). center_view (...,3) in RH view space
    (visible z < 0). Returns (aabb_min_xy, aabb_max_xy, valid) in NDC.
    """
    c = center_view
    cz = -c[..., 2]  # distance along view dir, positive in front
    valid = cz > radius + znear

    def axis_bounds(cx, cz):
        # 2D circle [cx, cz] radius r; find tangent lines through origin.
        # Tangent-point DIRECTIONS (vx, vz); the projected bound is the slope
        # vx/vz (x/z ratio) — scale factors cancel.
        t2 = xp.maximum(cx * cx + cz * cz - radius * radius, 1e-12)
        t = xp.sqrt(t2)
        inv = 1.0 / (cx * cx + cz * cz)
        # tangent directions (rotate c by +-asin(r/d))
        vx = (cx * t - cz * radius) * inv
        vz = (cz * t + cx * radius) * inv
        lo = vx / xp.maximum(vz, 1e-6)
        vx2 = (cx * t + cz * radius) * inv
        vz2 = (cz * t - cx * radius) * inv
        hi = vx2 / xp.maximum(vz2, 1e-6)
        return lo, hi

    min_x, max_x = axis_bounds(c[..., 0], cz)
    min_y, max_y = axis_bounds(c[..., 1], cz)
    mn = xp.stack([min_x * proj00, min_y * proj11], axis=-1)
    mx = xp.stack([max_x * proj00, max_y * proj11], axis=-1)
    return mn, mx, valid


# ---------------------------------------------------------------------------
# Octahedral encoding + vertex quantization
# (reference: src/SceneLoader.cpp:1946-1974, src/shaders/ unpack helpers)
# ---------------------------------------------------------------------------


def oct_encode(n, xp=np):
    """Unit vector -> octahedral (u,v) in [-1,1]^2."""
    n = n / xp.maximum(xp.sum(xp.abs(n), axis=-1, keepdims=True), 1e-20)
    u, v, z = n[..., 0], n[..., 1], n[..., 2]
    pu = (1.0 - xp.abs(v)) * xp.where(u >= 0.0, 1.0, -1.0)
    pv = (1.0 - xp.abs(u)) * xp.where(v >= 0.0, 1.0, -1.0)
    eu = xp.where(z < 0.0, pu, u)
    ev = xp.where(z < 0.0, pv, v)
    return xp.stack([eu, ev], axis=-1)


def oct_decode(e, xp=np):
    """Octahedral (u,v) in [-1,1]^2 -> unit vector."""
    u, v = e[..., 0], e[..., 1]
    z = 1.0 - xp.abs(u) - xp.abs(v)
    t = xp.maximum(-z, 0.0)
    u = u + xp.where(u >= 0.0, -t, t)
    v = v + xp.where(v >= 0.0, -t, t)
    n = xp.stack([u, v, z], axis=-1)
    return normalize(n, xp=xp)


def _unorm_pack(x, bits, xp):
    scale = float((1 << bits) - 1)
    q = xp.clip(xp.round((x * 0.5 + 0.5) * scale), 0, scale)
    return q.astype(xp.uint32)


def _unorm_unpack(q, bits, xp):
    scale = float((1 << bits) - 1)
    return (q.astype(xp.float32) / scale) * 2.0 - 1.0


def pack_normal_oct(n, bitangent_sign, xp=np):
    """Normal (..,3) + bitangent sign (+-1) -> uint32: oct u:10 | v:10 | sign:1.

    Parity target: the reference's 10:10:10 oct normal + bitangent sign
    (src/SceneLoader.cpp:1946-1974).
    """
    e = oct_encode(n, xp=xp)
    qu = _unorm_pack(e[..., 0], 10, xp)
    qv = _unorm_pack(e[..., 1], 10, xp)
    s = (xp.asarray(bitangent_sign) > 0).astype(xp.uint32)
    return qu | (qv << 10) | (s << 20)


def unpack_normal_oct(p, xp=np):
    """uint32 -> (normal (..,3), bitangent_sign (..,))."""
    p = p.astype(xp.uint32)
    u = _unorm_unpack(p & 0x3FF, 10, xp)
    v = _unorm_unpack((p >> 10) & 0x3FF, 10, xp)
    s = xp.where(((p >> 20) & 1) > 0, 1.0, -1.0).astype(xp.float32)
    return oct_decode(xp.stack([u, v], axis=-1), xp=xp), s


def pack_tangent_oct(t, xp=np):
    """Tangent (..,3) -> uint32 oct u:8 | v:8 (reference 8:8 oct tangent)."""
    e = oct_encode(t, xp=xp)
    qu = _unorm_pack(e[..., 0], 8, xp)
    qv = _unorm_pack(e[..., 1], 8, xp)
    return qu | (qv << 8)


def unpack_tangent_oct(p, xp=np):
    p = p.astype(xp.uint32)
    u = _unorm_unpack(p & 0xFF, 8, xp)
    v = _unorm_unpack((p >> 8) & 0xFF, 8, xp)
    return oct_decode(xp.stack([u, v], axis=-1), xp=xp)


def f32_to_f16_bits(x, xp=np):
    """float32 -> IEEE float16 bit pattern as uint32 (round-to-nearest)."""
    h = xp.asarray(x).astype(xp.float16)
    return h.view(xp.uint16).astype(xp.uint32)


def f16_bits_to_f32(b, xp=np):
    b16 = b.astype(xp.uint16)
    return b16.view(xp.float16).astype(xp.float32)


def pack_uv_half2(uv, xp=np):
    """UV (..,2) f32 -> uint32 (two f16 halves), ref half2 UV quantization."""
    lo = f32_to_f16_bits(uv[..., 0], xp=xp)
    hi = f32_to_f16_bits(uv[..., 1], xp=xp)
    return lo | (hi << 16)


def unpack_uv_half2(p, xp=np):
    p = p.astype(xp.uint32)
    u = f16_bits_to_f32(p & 0xFFFF, xp=xp)
    v = f16_bits_to_f32((p >> 16) & 0xFFFF, xp=xp)
    return xp.stack([u, v], axis=-1)


# ---------------------------------------------------------------------------
# Low-discrepancy sequences + misc
# ---------------------------------------------------------------------------


def halton(index, base: int, xp=np):
    """Halton sequence value(s) for integer index (array ok). Ref src/Utilities.cpp."""
    index = xp.asarray(index)
    f = xp.ones(index.shape, xp.float32) if hasattr(index, "shape") else 1.0
    result = xp.zeros_like(f)
    i = index.astype(xp.int32)
    # 32 digits of base>=2 cover any int32 index
    fb = np.float32(1.0 / base)
    scale = xp.ones_like(f) * fb
    for _ in range(20):
        digit = (i % base).astype(xp.float32)
        result = result + digit * scale
        i = i // base
        scale = scale * fb
    return result


def luminance(rgb, xp=np):
    return (rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722)


def reflect(d, n, xp=np):
    return d - 2.0 * xp.sum(d * n, axis=-1, keepdims=True) * n


def next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x - 1).bit_length())


def prev_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x).bit_length() - 1)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def ev100_from_camera(aperture_f: float, shutter_s: float, iso: float) -> float:
    """EV100 from physical camera params (reference Camera EV100 exposure)."""
    return float(np.log2((aperture_f * aperture_f) / shutter_s * 100.0 / iso))


def exposure_from_ev100(ev100, xp=np):
    """Photometric exposure scale: 1 / (1.2 * 2^EV100)."""
    return 1.0 / (1.2 * xp.exp2(ev100)) if hasattr(xp, "exp2") else 1.0 / (1.2 * 2.0 ** ev100)
