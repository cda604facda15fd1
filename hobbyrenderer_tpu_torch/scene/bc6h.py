"""BC6H (HDR half-float block compression) decode, vectorized numpy.

Reference: src/TextureLoader.cpp + src/Streaming/FeedbackTexture.cpp consume
BC6H_UF16/SF16 DDS assets (skyboxes, prebaked irradiance/radiance). PIL's
native "bcn" decoder handles BC6H but clamps to 8-bit RGB — useless for HDR —
so the float path is decoded here. Layout tables follow the public D3D11
functional spec / Khronos Data Format spec for BC6H; the decoder is
fuzz-validated against PIL's independent implementation (tests/test_textures
round-trips every mode).

Block = 128 bits, LSB-first. Mode = 2 bits if < 2 else 5 bits. Fields:
(rw,gw,bw)=e0 region0; (rx,gx,bx)=e1 region0; (ry..)=e0 region1; (rz..)=e1
region1; d = 5-bit partition (two-region modes only).
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# spec tables
# ---------------------------------------------------------------------------

# 2-subset partition table (shared with BC7), 64 x 16
PARTITIONS2 = np.array([
    [0,0,1,1, 0,0,1,1, 0,0,1,1, 0,0,1,1],
    [0,0,0,1, 0,0,0,1, 0,0,0,1, 0,0,0,1],
    [0,1,1,1, 0,1,1,1, 0,1,1,1, 0,1,1,1],
    [0,0,0,1, 0,0,1,1, 0,0,1,1, 0,1,1,1],
    [0,0,0,0, 0,0,0,1, 0,0,0,1, 0,0,1,1],
    [0,0,1,1, 0,1,1,1, 0,1,1,1, 1,1,1,1],
    [0,0,0,1, 0,0,1,1, 0,1,1,1, 1,1,1,1],
    [0,0,0,0, 0,0,0,1, 0,0,1,1, 0,1,1,1],
    [0,0,0,0, 0,0,0,0, 0,0,0,1, 0,0,1,1],
    [0,0,1,1, 0,1,1,1, 1,1,1,1, 1,1,1,1],
    [0,0,0,0, 0,0,0,1, 0,1,1,1, 1,1,1,1],
    [0,0,0,0, 0,0,0,0, 0,0,0,1, 0,1,1,1],
    [0,0,0,1, 0,1,1,1, 1,1,1,1, 1,1,1,1],
    [0,0,0,0, 0,0,0,0, 1,1,1,1, 1,1,1,1],
    [0,0,0,0, 1,1,1,1, 1,1,1,1, 1,1,1,1],
    [0,0,0,0, 0,0,0,0, 0,0,0,0, 1,1,1,1],
    [0,0,0,0, 1,0,0,0, 1,1,1,0, 1,1,1,1],
    [0,1,1,1, 0,0,0,1, 0,0,0,0, 0,0,0,0],
    [0,0,0,0, 0,0,0,0, 1,0,0,0, 1,1,1,0],
    [0,1,1,1, 0,0,1,1, 0,0,0,1, 0,0,0,0],
    [0,0,1,1, 0,0,0,1, 0,0,0,0, 0,0,0,0],
    [0,0,0,0, 1,0,0,0, 1,1,0,0, 1,1,1,0],
    [0,0,0,0, 0,0,0,0, 1,0,0,0, 1,1,0,0],
    [0,1,1,1, 0,0,1,1, 0,0,1,1, 0,0,0,1],
    [0,0,1,1, 0,0,0,1, 0,0,0,1, 0,0,0,0],
    [0,0,0,0, 1,0,0,0, 1,0,0,0, 1,1,0,0],
    [0,1,1,0, 0,1,1,0, 0,1,1,0, 0,1,1,0],
    [0,0,1,1, 0,1,1,0, 0,1,1,0, 1,1,0,0],
    [0,0,0,1, 0,1,1,1, 1,1,1,0, 1,0,0,0],
    [0,0,0,0, 1,1,1,1, 1,1,1,1, 0,0,0,0],
    [0,1,1,1, 0,0,0,1, 1,0,0,0, 1,1,1,0],
    [0,0,1,1, 1,0,0,1, 1,0,0,1, 1,1,0,0],
    [0,1,0,1, 0,1,0,1, 0,1,0,1, 0,1,0,1],
    [0,0,0,0, 1,1,1,1, 0,0,0,0, 1,1,1,1],
    [0,1,0,1, 1,0,1,0, 0,1,0,1, 1,0,1,0],
    [0,0,1,1, 0,0,1,1, 1,1,0,0, 1,1,0,0],
    [0,0,1,1, 1,1,0,0, 0,0,1,1, 1,1,0,0],
    [0,1,0,1, 0,1,0,1, 1,0,1,0, 1,0,1,0],
    [0,1,1,0, 1,0,0,1, 0,1,1,0, 1,0,0,1],
    [0,1,0,1, 1,0,1,0, 1,0,1,0, 0,1,0,1],
    [0,1,1,1, 0,0,1,1, 1,1,0,0, 1,1,1,0],
    [0,0,0,1, 0,0,1,1, 1,1,0,0, 1,0,0,0],
    [0,0,1,1, 0,0,1,0, 0,1,0,0, 1,1,0,0],
    [0,0,1,1, 1,0,1,1, 1,1,0,1, 1,1,0,0],
    [0,1,1,0, 1,0,0,1, 1,0,0,1, 0,1,1,0],
    [0,0,1,1, 1,1,0,0, 1,1,0,0, 0,0,1,1],
    [0,1,1,0, 0,1,1,0, 1,0,0,1, 1,0,0,1],
    [0,0,0,0, 0,1,1,0, 0,1,1,0, 0,0,0,0],
    [0,1,0,0, 1,1,1,0, 0,1,0,0, 0,0,0,0],
    [0,0,1,0, 0,1,1,1, 0,0,1,0, 0,0,0,0],
    [0,0,0,0, 0,0,1,0, 0,1,1,1, 0,0,1,0],
    [0,0,0,0, 0,1,0,0, 1,1,1,0, 0,1,0,0],
    [0,1,1,0, 1,1,0,0, 1,0,0,1, 0,0,1,1],
    [0,0,1,1, 0,1,1,0, 1,1,0,0, 1,0,0,1],
    [0,1,1,0, 0,0,1,1, 1,0,0,1, 1,1,0,0],
    [0,0,1,1, 1,0,0,1, 1,1,0,0, 0,1,1,0],
    [0,1,1,0, 1,1,0,0, 1,1,0,0, 1,0,0,1],
    [0,1,1,0, 0,0,1,1, 0,0,1,1, 1,0,0,1],
    [0,1,1,1, 1,1,1,0, 1,0,0,0, 0,0,0,1],
    [0,0,0,1, 1,0,0,0, 1,1,1,0, 0,1,1,1],
    [0,0,0,0, 1,1,1,1, 0,0,1,1, 0,0,1,1],
    [0,0,1,1, 0,0,1,1, 1,1,1,1, 0,0,0,0],
    [0,0,1,0, 0,0,1,0, 1,1,1,1, 0,0,1,0],
    [0,1,0,0, 0,1,0,0, 1,1,1,1, 0,1,0,0],
], np.int32)

# anchor index of the SECOND subset, per partition (first subset anchors at 0)
ANCHORS2 = np.array([
    15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,
    15, 2, 8, 2, 2, 8, 8,15, 2, 8, 2, 2, 8, 8, 2, 2,
    15,15, 6, 8, 2, 8,15,15, 2, 8, 2, 2, 2,15,15, 6,
     6, 2, 6, 8,15,15, 2, 2,15,15,15,15,15, 2, 2,15,
], np.int32)

W3 = np.array([0, 9, 18, 27, 37, 46, 55, 64], np.int32)
W4 = np.array([0, 4, 9, 13, 17, 21, 26, 30,
               34, 38, 43, 47, 51, 55, 60, 64], np.int32)

# ---------------------------------------------------------------------------
# mode layouts (D3D11 functional spec, "BC6H bit layout" tables)
# tokens: mN = N mode bits (skipped); <field><bit> single; <field>lo-hi
# ascending run; <field>hi~lo DESCENDING run (modes 13/14 store high endpoint
# bits MSB-first)
# ---------------------------------------------------------------------------

_LAYOUTS = {
    0b00: "m2 gy4 by4 bz4 rw0-9 gw0-9 bw0-9 rx0-4 gz4 gy0-3 gx0-4 bz0 gz0-3"
          " bx0-4 bz1 by0-3 ry0-4 bz2 rz0-4 bz3 d0-4",
    0b01: "m2 gy5 gz4 gz5 rw0-6 bz0 bz1 by4 gw0-6 by5 bz2 gy4 bw0-6 bz3 bz5"
          " bz4 rx0-5 gy0-3 gx0-5 gz0-3 bx0-5 by0-3 ry0-5 rz0-5 d0-4",
    0b00010: "m5 rw0-9 gw0-9 bw0-9 rx0-4 rw10 gy0-3 gx0-3 gw10 bz0 gz0-3"
             " bx0-3 bw10 bz1 by0-3 ry0-4 bz2 rz0-4 bz3 d0-4",
    0b00110: "m5 rw0-9 gw0-9 bw0-9 rx0-3 rw10 gz4 gy0-3 gx0-4 gw10 gz0-3"
             " bx0-3 bw10 bz1 by0-3 ry0-3 bz0 bz2 rz0-3 gy4 bz3 d0-4",
    0b01010: "m5 rw0-9 gw0-9 bw0-9 rx0-3 rw10 by4 gy0-3 gx0-3 gw10 bz0 gz0-3"
             " bx0-4 bw10 by0-3 ry0-3 bz1 bz2 rz0-3 bz4 bz3 d0-4",
    0b01110: "m5 rw0-8 by4 gw0-8 gy4 bw0-8 bz4 rx0-4 gz4 gy0-3 gx0-4 bz0"
             " gz0-3 bx0-4 bz1 by0-3 ry0-4 bz2 rz0-4 bz3 d0-4",
    0b10010: "m5 rw0-7 gz4 by4 gw0-7 bz2 gy4 bw0-7 bz3 bz4 rx0-5 gy0-3"
             " gx0-4 bz0 gz0-3 bx0-4 bz1 by0-3 ry0-5 rz0-5 d0-4",
    0b10110: "m5 rw0-7 bz0 by4 gw0-7 gy5 gy4 bw0-7 gz5 bz4 rx0-4 gz4 gy0-3"
             " gx0-5 gz0-3 bx0-4 bz1 by0-3 ry0-4 bz2 rz0-4 bz3 d0-4",
    0b11010: "m5 rw0-7 bz1 by4 gw0-7 by5 gy4 bw0-7 bz5 bz4 rx0-4 gz4 gy0-3"
             " gx0-4 bz0 gz0-3 bx0-5 by0-3 ry0-4 bz2 rz0-4 bz3 d0-4",
    0b11110: "m5 rw0-5 gz4 bz0 bz1 by4 gw0-5 gy5 by5 bz2 gy4 bw0-5 gz5 bz3"
             " bz5 bz4 rx0-5 gy0-3 gx0-5 gz0-3 bx0-5 by0-3 ry0-5 rz0-5 d0-4",
    0b00011: "m5 rw0-9 gw0-9 bw0-9 rx0-9 gx0-9 bx0-9",
    0b00111: "m5 rw0-9 gw0-9 bw0-9 rx0-8 rw10 gx0-8 gw10 bx0-8 bw10",
    0b01011: "m5 rw0-9 gw0-9 bw0-9 rx0-7 rw11~10 gx0-7 gw11~10 bx0-7 bw11~10",
    0b01111: "m5 rw0-9 gw0-9 bw0-9 rx0-3 rw15~10 gx0-3 gw15~10 bx0-3 bw15~10",
}

# mode -> (endpoint precision bits, delta widths (r, g, b) or None, n_regions)
_MODES = {
    0b00:    (10, (5, 5, 5), 2),
    0b01:    (7,  (6, 6, 6), 2),
    0b00010: (11, (5, 4, 4), 2),
    0b00110: (11, (4, 5, 4), 2),
    0b01010: (11, (4, 4, 5), 2),
    0b01110: (9,  (5, 5, 5), 2),
    0b10010: (8,  (6, 5, 5), 2),
    0b10110: (8,  (5, 6, 5), 2),
    0b11010: (8,  (5, 5, 6), 2),
    0b11110: (6,  None,      2),
    0b00011: (10, None,      1),
    0b00111: (11, (9, 9, 9), 1),
    0b01011: (12, (8, 8, 8), 1),
    0b01111: (16, (4, 4, 4), 1),
}


_FIELDS = ("rw", "gw", "bw", "rx", "gx", "bx",
           "ry", "gy", "by", "rz", "gz", "bz")


def _parse_layout(spec: str):
    """layout string -> list of (field, dest_bit) in block-bit order."""
    out = []
    for tok in spec.split():
        if tok[0] == "m" and tok[1:].isdigit():
            out.extend([(None, 0)] * int(tok[1:]))
            continue
        name = tok[:2] if tok[:2] in _FIELDS else "d"
        rest = tok[2:] if name != "d" else tok[1:]
        if "~" in rest:                       # descending run hi~lo
            hi, lo = map(int, rest.split("~"))
            out.extend((name, b) for b in range(hi, lo - 1, -1))
        elif "-" in rest:                     # ascending run lo-hi
            lo, hi = map(int, rest.split("-"))
            out.extend((name, b) for b in range(lo, hi + 1))
        else:
            out.append((name, int(rest)))
    return out


_PARSED = {m: _parse_layout(s) for m, s in _LAYOUTS.items()}
for _m, _p in _PARSED.items():
    _n = len(_p)
    assert _n in (82, 65), (_m, _n)   # 82 two-region / 65 one-region header


def _get_bit(blocks: np.ndarray, pos: int) -> np.ndarray:
    return (blocks[:, pos >> 3] >> (pos & 7)) & 1


def _extract_fields(blocks: np.ndarray, mode: int):
    fields = {k: np.zeros(blocks.shape[0], np.int32)
              for k in ("rw", "gw", "bw", "rx", "gx", "bx",
                        "ry", "gy", "by", "rz", "gz", "bz", "d")}
    for pos, (name, dest) in enumerate(_PARSED[mode]):
        if name is None:
            continue
        fields[name] |= _get_bit(blocks, pos).astype(np.int32) << dest
    return fields


def _sign_extend(v: np.ndarray, bits: int) -> np.ndarray:
    s = 1 << (bits - 1)
    return (v ^ s) - s


def _unquantize(q: np.ndarray, epb: int, signed: bool) -> np.ndarray:
    if signed:
        if epb >= 16:
            return q
        s = q < 0
        a = np.abs(q)
        unq = np.where(a == 0, 0,
                       np.where(a >= ((1 << (epb - 1)) - 1), 0x7FFF,
                                ((a << 15) + 0x4000) >> (epb - 1)))
        return np.where(s, -unq, unq)
    if epb >= 15:
        return q
    return np.where(q == 0, 0,
                    np.where(q == (1 << epb) - 1, 0xFFFF,
                             ((q << 15) + 0x4000) >> (epb - 1)))


def _finish(v: np.ndarray, signed: bool) -> np.ndarray:
    """Post-interpolation scale -> half-float bit pattern (uint16)."""
    if signed:
        s = v < 0
        a = (np.abs(v) * 31) >> 5
        bits = np.where(s, 0x8000 | a, a).astype(np.uint16)
    else:
        bits = ((v * 31) >> 6).astype(np.uint16)
    return bits


def decode_bc6h_blocks(blocks: np.ndarray, signed: bool = False) -> np.ndarray:
    """(N, 16) uint8 BC6H blocks -> (N, 4, 4, 3) float32 linear HDR."""
    blocks = np.ascontiguousarray(blocks, np.uint8)
    N = blocks.shape[0]
    out = np.zeros((N, 16, 3), np.float32)

    m2 = blocks[:, 0] & 3
    mode = np.where(m2 < 2, m2, blocks[:, 0] & 31).astype(np.int32)

    for m, (epb, deltas, nreg) in _MODES.items():
        sel = np.nonzero(mode == m)[0]
        if sel.size == 0:
            continue
        b = blocks[sel]
        f = _extract_fields(b, m)
        e = {}
        if signed:
            f = dict(f)
            for k in ("rw", "gw", "bw"):
                f[k] = _sign_extend(f[k], epb)
        mask = (1 << epb) - 1
        for ci, (c0, c1, c2, c3) in enumerate(
                (("rw", "rx", "ry", "rz"), ("gw", "gx", "gy", "gz"),
                 ("bw", "bx", "by", "bz"))):
            base = f[c0]
            if deltas is not None:
                dw = deltas[ci]
                d1 = _sign_extend(f[c1], dw)
                d2 = _sign_extend(f[c2], dw)
                d3 = _sign_extend(f[c3], dw)
                v1 = (base + d1) & mask
                v2 = (base + d2) & mask
                v3 = (base + d3) & mask
                if signed:
                    v1, v2, v3 = (_sign_extend(v, epb) for v in (v1, v2, v3))
            else:
                v1, v2, v3 = f[c1], f[c2], f[c3]
                if signed:
                    v1, v2, v3 = (_sign_extend(v, epb) for v in (v1, v2, v3))
            e[ci] = [_unquantize(v, epb, signed) for v in (base, v1, v2, v3)]

        # indices
        if nreg == 2:
            d_part = f["d"]
            subset = PARTITIONS2[d_part]                       # (n, 16)
            anchor1 = ANCHORS2[d_part]                         # (n,)
            weights = W3
            idx_bits = 3
            start0 = 82
        else:
            subset = np.zeros((sel.size, 16), np.int32)
            anchor1 = np.full(sel.size, -1, np.int32)
            weights = W4
            idx_bits = 4
            start0 = 65

        # per-pixel variable-width index extraction (anchors: 1 bit less)
        pad = np.concatenate([b, np.zeros((sel.size, 3), np.uint8)], 1)

        def get_bits_var(start, count_arr):
            byte = (start >> 3).astype(np.int64)
            sh = start & 7
            b0 = np.take_along_axis(pad, byte[:, None], 1)[:, 0].astype(np.uint32)
            b1 = np.take_along_axis(pad, byte[:, None] + 1, 1)[:, 0].astype(np.uint32)
            b2 = np.take_along_axis(pad, byte[:, None] + 2, 1)[:, 0].astype(np.uint32)
            word = b0 | (b1 << 8) | (b2 << 16)
            return (word >> sh) & ((1 << count_arr) - 1)

        cursor = np.full(sel.size, start0, np.int32)
        idx = np.zeros((sel.size, 16), np.int32)
        for p in range(16):
            is_anchor = (p == 0) | (p == anchor1)
            nb = np.where(is_anchor, idx_bits - 1, idx_bits)
            idx[:, p] = get_bits_var(cursor, nb)
            cursor = cursor + nb

        w = weights[idx]                                       # (n, 16)
        for ci in range(3):
            e0 = np.where(subset == 0, e[ci][0][:, None], e[ci][2][:, None])
            e1 = np.where(subset == 0, e[ci][1][:, None], e[ci][3][:, None])
            interp = (e0 * (64 - w) + e1 * w + 32) >> 6
            half = np.ascontiguousarray(_finish(interp, signed))
            out[sel, :, ci] = half.view(np.float16).astype(np.float32)

    res = out.reshape(N, 4, 4, 3)
    # scrub NaN/Inf from malformed blocks (spec: invalid modes decode to 0)
    return np.nan_to_num(res, nan=0.0, posinf=65504.0, neginf=-65504.0)
