"""Host-side image IO (the "present"/screenshot path).

Reference: Renderer::SaveBackBufferScreenshot (src/Renderer.cpp:218-271) copies the
backbuffer to a staging buffer and writes a file. TPU equivalent: device_get the final
tonemapped (H, W, 3) uint8 array — the ONLY per-frame host transfer (north star) — and
encode PNG with zero external deps (stdlib zlib)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3|4) uint8 (or float in [0,1]) image as PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(np.round(np.asarray(img, np.float32) * 255.0), 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    h, w, c = img.shape
    assert c in (3, 4), f"unsupported channel count {c}"
    color_type = 2 if c == 3 else 6

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader (8-bit RGB/RGBA/grayscale, no interlace) for tests."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = bitd = ctype = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, bitd, ctype = struct.unpack(">IIBB", body[:10])
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + length
    assert bitd == 8, "only 8-bit PNG supported"
    nch = {0: 1, 2: 3, 6: 4}[ctype]
    raw = zlib.decompress(idat)
    stride = w * nch
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ft = raw[y * (stride + 1)]
        line = np.frombuffer(raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)], np.uint8).astype(np.int32)
        if ft == 0:
            cur = line
        elif ft == 2:  # up
            cur = (line + prev) & 0xFF
        else:
            # sub / average / paeth need sequential scan
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - nch] if x >= nch else 0
                b = prev[x]
                cc = prev[x - nch] if x >= nch else 0
                if ft == 1:
                    pred = a
                elif ft == 3:
                    pred = (a + b) // 2
                else:  # paeth
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out.reshape(h, w, nch)
