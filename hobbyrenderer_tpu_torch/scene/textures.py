"""Texture layer: image decode + the device texel table.

Reference: src/TextureLoader.cpp (370 LoC, DDS + stb_image decode ->
nvrhi::TextureDesc + mmap'd pixels) and the bindless texture tables
(src/Renderer.cpp:1460-1579, src/shaders/Bindless.hlsli) consumed by
BasePass.hlsl:271-518 material sampling.

TPU-first design — one packed MIP-CHAINED TEXEL TABLE instead of bindless
descriptors:
- Per MATERIAL, its four texture types (base color, normal, ORM, emissive) are
  resampled to one power-of-two resolution and packed per texel into 4 uint32
  words, so shading needs exactly ONE row gather per sample (gathers are the
  scarce resource on TPU — ~20 ns per row regardless of width).
- The full mip chain (down to 1x1) is concatenated; `mat_mip_off` indexes it.
- Untextured materials get a single 1x1 NEUTRAL texel (white albedo, flat
  normal, unit ORM/emissive multipliers), so the sampling path is branch-free:
  glTF semantics are `final = factor * texture` and the neutral texel is 1.

Texel word layout (little endian u8 lanes):
  w0 = base color RGBA (sRGB-encoded, as authored)
  w1 = normal X, normal Y (tangent space, [0,255] ~ [-1,1]), occlusion, roughness
  w2 = metallic, emissive RGB (sRGB-encoded)
  w3 = spare
"""

from __future__ import annotations

import io
import struct
from typing import Dict, List, Optional

import numpy as np

MAX_TEX_SIZE = 1024
MAX_MIPS = 11           # 1024 -> 1


# --------------------------------------------------------------------------
# image decode (ref TextureLoader.cpp: DDS + stb paths)
# --------------------------------------------------------------------------

def decode_image_bytes(data: bytes) -> np.ndarray:
    """bytes (PNG/JPEG/DDS/...) -> (H, W, 4) uint8 RGBA."""
    if data[:4] == b"DDS ":
        img = decode_dds(data)
        if img.dtype != np.uint8:
            # HDR (BC6H) content bound as an LDR material map: sRGB-encode +
            # clip (the envmap path keeps the floats — ops/envmap.load_envmap)
            ldr = np.clip(img[..., :3], 0.0, 1.0) ** (1.0 / 2.2)
            a = np.full((*ldr.shape[:2], 1), 255, np.uint8)
            return np.concatenate([(ldr * 255 + 0.5).astype(np.uint8), a], -1)
        return img
    from PIL import Image
    img = Image.open(io.BytesIO(data)).convert("RGBA")
    return np.asarray(img, np.uint8)


def load_image_file(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_image_bytes(f.read())


def _bc_interp_colors(c0, c1, mode_bc1):
    """DXT color palette: c0/c1 (N,) uint16 565 -> (N, 4, 3) uint8."""
    def un565(c):
        r = ((c >> 11) & 31).astype(np.uint16)
        g = ((c >> 5) & 63).astype(np.uint16)
        b = (c & 31).astype(np.uint16)
        return np.stack([(r * 527 + 23) >> 6, (g * 259 + 33) >> 6,
                         (b * 527 + 23) >> 6], -1).astype(np.int32)
    p0, p1 = un565(c0), un565(c1)
    third = ((2 * p0 + p1) // 3)
    two_third = ((p0 + 2 * p1) // 3)
    half = (p0 + p1) // 2
    if mode_bc1:
        # per-block: c0 > c1 -> 4-color, else 3-color + transparent black
        four = (c0 > c1)[:, None]
        p2 = np.where(four, third, half)
        p3 = np.where(four, two_third, 0)
    else:
        p2, p3 = third, two_third
    return np.stack([p0, p1, p2, p3], 1).astype(np.uint8)   # (N, 4, 3)


def _decode_bc1_blocks(blocks: np.ndarray, bc1_alpha: bool,
                       mode_bc1: bool = True) -> np.ndarray:
    """(N, 8) uint8 BC1-style color blocks -> (N, 4, 4, 4) RGBA.

    mode_bc1=False for the color half of BC2/BC3: those ALWAYS use the
    4-color palette regardless of the c0<=c1 ordering."""
    c0 = blocks[:, 0].astype(np.uint16) | (blocks[:, 1].astype(np.uint16) << 8)
    c1 = blocks[:, 2].astype(np.uint16) | (blocks[:, 3].astype(np.uint16) << 8)
    bits = (blocks[:, 4].astype(np.uint32) | (blocks[:, 5].astype(np.uint32) << 8)
            | (blocks[:, 6].astype(np.uint32) << 16)
            | (blocks[:, 7].astype(np.uint32) << 24))
    pal = _bc_interp_colors(c0, c1, mode_bc1=mode_bc1)      # (N, 4, 3)
    idx = (bits[:, None] >> (2 * np.arange(16, dtype=np.uint32))) & 3  # (N, 16)
    rgb = np.take_along_axis(pal, idx[..., None].astype(np.int64), 1)  # (N,16,3)
    a = np.full((blocks.shape[0], 16, 1), 255, np.uint8)
    if bc1_alpha:
        transparent = (c0 <= c1)[:, None] & (idx == 3)
        a = np.where(transparent[..., None], 0, a).astype(np.uint8)
    return np.concatenate([rgb, a], -1).reshape(-1, 4, 4, 4)


def _decode_bc_alpha_blocks(blocks: np.ndarray) -> np.ndarray:
    """(N, 8) uint8 BC4-style alpha blocks -> (N, 16) uint8."""
    a0 = blocks[:, 0].astype(np.int32)
    a1 = blocks[:, 1].astype(np.int32)
    bits = np.zeros(blocks.shape[0], np.uint64)
    for k in range(6):
        bits |= blocks[:, 2 + k].astype(np.uint64) << np.uint64(8 * k)
    idx = ((bits[:, None] >> (3 * np.arange(16, dtype=np.uint64)))
           & np.uint64(7)).astype(np.int32)                  # (N, 16)
    pal = np.zeros((blocks.shape[0], 8), np.int32)
    pal[:, 0] = a0
    pal[:, 1] = a1
    eight = a0 > a1
    for k in range(1, 7):
        pal[:, k + 1] = np.where(eight, ((7 - k) * a0 + k * a1) // 7,
                                 np.where(k <= 4, ((5 - k) * a0 + k * a1) // 5,
                                          np.where(k == 5, 0, 255)))
    return np.take_along_axis(pal, idx, 1).astype(np.uint8)


def decode_dds(data: bytes) -> np.ndarray:
    """Minimal DDS decode (top mip only — our table rebuilds the chain):
    uncompressed RGBA/BGRA + BC1-5 (numpy), BC7 (PIL's native bcn decoder),
    BC6H (scene/bc6h.py, the float path PIL clamps away).

    Returns (H, W, 4) uint8 RGBA for LDR formats; (H, W, 3) float32 linear
    for BC6H (ref TextureLoader.cpp consumes BC6H skyboxes/irradiance)."""
    assert data[:4] == b"DDS ", "not a DDS file"
    (size, flags, h, w) = struct.unpack_from("<IIII", data, 4)
    pf_flags, fourcc = struct.unpack_from("<II", data, 80)
    rgb_bitcount, rmask, gmask, bmask, amask = struct.unpack_from("<IIIII", data, 88)
    off = 4 + 124
    fcc = struct.pack("<I", fourcc)
    if fcc == b"DX10":
        dxgi, = struct.unpack_from("<I", data, off)
        off += 20
        dxgi_map = {71: b"DXT1", 72: b"DXT1", 74: b"DXT3", 75: b"DXT3",
                    77: b"DXT5", 78: b"DXT5", 80: b"BC4U", 83: b"BC5U",
                    94: b"BC6U", 95: b"BC6U", 96: b"BC6S",
                    97: b"BC7 ", 98: b"BC7 ", 99: b"BC7 ",
                    28: b"RGBA", 87: b"BGRA"}
        fcc = dxgi_map.get(dxgi, b"????")
    bw, bh = (w + 3) // 4, (h + 3) // 4
    if fcc in (b"BC6U", b"BC6S"):
        from hobbyrenderer_tpu_torch.scene.bc6h import decode_bc6h_blocks
        blocks = np.frombuffer(data, np.uint8, count=bw * bh * 16,
                               offset=off).reshape(-1, 16)
        px = decode_bc6h_blocks(blocks, signed=fcc == b"BC6S")
        img = px.reshape(bh, bw, 4, 4, 3).transpose(0, 2, 1, 3, 4) \
            .reshape(bh * 4, bw * 4, 3)
        return np.ascontiguousarray(img[:h, :w])
    if fcc == b"BC7 ":
        # PIL ships a native, battle-tested BC7 decoder; BC7 is UNORM so the
        # u8 path is exact
        import io as _io
        from PIL import Image
        img = Image.open(_io.BytesIO(data)).convert("RGBA")
        return np.asarray(img, np.uint8)[:h, :w]
    if pf_flags & 0x40 or fcc in (b"RGBA", b"BGRA"):        # uncompressed
        bpp = rgb_bitcount if rgb_bitcount else 32
        if bpp == 32:
            raw = np.frombuffer(data, np.uint8, count=w * h * 4,
                                offset=off).reshape(h, w, 4)
        elif bpp == 24:
            rgb = np.frombuffer(data, np.uint8, count=w * h * 3,
                                offset=off).reshape(h, w, 3)
            raw = np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1)
        else:
            raise ValueError(f"unsupported uncompressed DDS bit depth {bpp}")
        if fcc == b"BGRA" or (bmask == 0xFF and rmask == 0xFF0000):
            raw = np.ascontiguousarray(raw)[..., [2, 1, 0, 3]]
        return np.ascontiguousarray(raw)
    blocks = np.frombuffer(data, np.uint8, count=bw * bh * (8 if fcc in (b"DXT1", b"BC4U") else 16),
                           offset=off)
    if fcc == b"DXT1":
        px = _decode_bc1_blocks(blocks.reshape(-1, 8), bc1_alpha=True)
    elif fcc in (b"DXT3", b"DXT5"):
        b2 = blocks.reshape(-1, 16)
        px = _decode_bc1_blocks(b2[:, 8:], bc1_alpha=False, mode_bc1=False)
        if fcc == b"DXT5":
            a = _decode_bc_alpha_blocks(b2[:, :8])
        else:                                               # BC2: explicit 4-bit
            a4 = b2[:, :8]
            a = np.zeros((b2.shape[0], 16), np.uint8)
            for k in range(8):
                a[:, 2 * k] = (a4[:, k] & 15) * 17
                a[:, 2 * k + 1] = (a4[:, k] >> 4) * 17
        px[..., 3] = a.reshape(-1, 4, 4)
    elif fcc == b"BC4U":
        r = _decode_bc_alpha_blocks(blocks.reshape(-1, 8)).reshape(-1, 4, 4)
        px = np.stack([r, r, r, np.full_like(r, 255)], -1)
    elif fcc == b"BC5U":
        b2 = blocks.reshape(-1, 16)
        r = _decode_bc_alpha_blocks(b2[:, :8]).reshape(-1, 4, 4)
        g = _decode_bc_alpha_blocks(b2[:, 8:]).reshape(-1, 4, 4)
        px = np.stack([r, g, np.full_like(r, 128), np.full_like(r, 255)], -1)
    else:
        raise ValueError(f"unsupported DDS format {fcc!r}")
    # (bw*bh, 4, 4, 4) -> (h, w, 4)
    img = px.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4).reshape(bh * 4, bw * 4, 4)
    return np.ascontiguousarray(img[:h, :w])


# --------------------------------------------------------------------------
# the packed texel table
# --------------------------------------------------------------------------

def _resize_u8(img: np.ndarray, s: int) -> np.ndarray:
    """Box/area resample (H, W, C) u8 -> (s, s, C) via PIL (quality) with a
    numpy fallback."""
    if img.shape[0] == s and img.shape[1] == s:
        return img
    from PIL import Image
    mode = "RGBA" if img.shape[2] == 4 else "RGB"
    return np.asarray(Image.fromarray(img, mode).resize((s, s), Image.LANCZOS
                                                        if s < max(img.shape[:2])
                                                        else Image.BILINEAR),
                      np.uint8)


def _mip_chain(img: np.ndarray) -> List[np.ndarray]:
    """Power-of-two box-filtered mip chain down to 1x1 (f32 in [0,255])."""
    chain = [img.astype(np.float32)]
    x = chain[0]
    while x.shape[0] > 1:
        s = x.shape[0] // 2
        x = x.reshape(s, 2, s, 2, x.shape[-1]).mean((1, 3))
        chain.append(x)
    return chain


NEUTRAL = np.array([255, 255, 255, 255,    # albedo RGBA
                    128, 128, 255, 255,    # normal XY, occlusion, roughness
                    255, 255, 255, 255,    # metallic, emissive RGB
                    0, 0, 0, 0], np.uint8)


def material_texel_chain(scene, mi: int) -> Optional[List[np.ndarray]]:
    """One material's packed-texel mip chain: list of (S, S, 16) uint8 arrays
    (w0..w3 byte layout per module doc), or None for untextured materials.

    This is the pixel SOURCE shared by the dense table build and the
    streaming tile loader (scene/streaming.py AsyncTileIO analogue)."""
    images: List[Optional[np.ndarray]] = getattr(scene, "images", []) or []
    m = scene.materials[mi]

    def get_img(i):
        if i is None or i < 0 or i >= len(images) or images[i] is None:
            return None
        return images[i]

    srcs = [get_img(m.base_color_tex), get_img(m.normal_tex),
            get_img(m.orm_tex), get_img(m.emissive_tex)]
    dims = [max(s.shape[0], s.shape[1]) for s in srcs if s is not None]
    if not dims:
        return None
    s = 1 << int(np.ceil(np.log2(min(max(dims), MAX_TEX_SIZE))))
    s = max(s, 4)

    def fetch(img, default):
        if img is None:
            return np.broadcast_to(np.asarray(default, np.uint8),
                                   (s, s, len(default))).copy()
        return _resize_u8(img, s)[..., :len(default)]

    base = fetch(srcs[0], (255, 255, 255, 255))          # sRGB RGBA
    nrm = fetch(srcs[1], (128, 128, 255))                # tangent-space
    orm = fetch(srcs[2], (255, 255, 255))                # occ, rough, metal
    emis = fetch(srcs[3], (255, 255, 255))               # sRGB
    texel = np.concatenate([
        base,
        nrm[..., 0:2], orm[..., 0:1], orm[..., 1:2],
        orm[..., 2:3], emis[..., 0:3],
        np.zeros((s, s, 4), np.uint8),
    ], -1)
    return [np.clip(np.round(lvl), 0, 255).astype(np.uint8)
            for lvl in _mip_chain(texel)]


def build_texture_table(scene) -> Dict[str, np.ndarray]:
    """Pack every material's textures into the global mip-chained texel table.

    Returns arrays for SceneGPU: tex_table (T, 4) u32, mat_tex_size (Mat,) i32,
    mat_mip_off (Mat, MAX_MIPS) i32 (absolute row offsets per level)."""
    mats = scene.materials
    M = len(mats)
    rows: List[np.ndarray] = []
    mat_size = np.ones(M, np.int32)
    mip_off = np.zeros((M, MAX_MIPS), np.int32)
    cursor = 0

    for mi, m in enumerate(mats):
        chain = material_texel_chain(scene, mi)
        if chain is None:
            mat_size[mi] = 1
            mip_off[mi, :] = cursor
            rows.append(NEUTRAL[None, :])
            cursor += 1
            continue
        mat_size[mi] = chain[0].shape[0]
        lvl_cursor = cursor
        last_off = cursor
        for li in range(MAX_MIPS):
            if li < len(chain):
                mip_off[mi, li] = lvl_cursor
                last_off = lvl_cursor
                lvl = chain[li]
                rows.append(lvl.reshape(-1, 16))
                lvl_cursor += lvl.shape[0] * lvl.shape[1]
            else:
                # levels beyond the chain repeat the last (1x1) level
                mip_off[mi, li] = last_off
        cursor = lvl_cursor

    table_u8 = np.concatenate(rows, 0) if rows else NEUTRAL[None, :]
    table = table_u8.reshape(-1, 4, 4).view(np.uint32).reshape(-1, 4)
    return dict(tex_table=np.ascontiguousarray(table),
                mat_tex_size=mat_size, mat_mip_off=mip_off)
