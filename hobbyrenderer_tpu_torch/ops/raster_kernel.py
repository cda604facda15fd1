"""Tile rasters: record builders, the CUDA kernels' wrappers and their
plain PyTorch versions.

Counterpart of hobbyrenderer_tpu/ops/raster_pallas.py: K1
(raster_resolve_tiles, raster + fused attribute resolve) and K5
(raster_tiles, depth and winner id only; the shadow atlas runs it depth
only). Both are one kernel template in csrc/raster_resolve.cu: persistent
CTAs take work units from a queue, a unit being at most ``UNIT_ITEMS`` of a
tile's worklist items (``split_units``, planned by the kernels' first
launch); each warp evaluates only the triangle rows that can reach its
pixel rows (``_rows_outside_strips``), and the units of a split tile merge
order-free. ``raster_resolve_tiles`` and ``raster_tiles`` launch it for
CUDA tensors and run ``raster_resolve_tiles_reference`` /
``raster_tiles_reference`` for CPU tensors; nothing else chooses."""

from __future__ import annotations

import ctypes

import torch

from hobbyrenderer_tpu_torch import kernels

TILE = 32
PIX = TILE * TILE
MAX_TRIS = 96
TRI_CHUNK = 32
N_CHUNKS = MAX_TRIS // TRI_CHUNK
REC_LANES = 128
# depth records: the 9 raster-plane lanes padded to 16 (the TPU pads to 128
# for its DMA alignment; no result depends on the padding)
REC_LANES_DEPTH = 16
ATTR_ROWS = 16
REF_ITEM_BATCH = 256    # worklist items per step of the plain versions
UNIT_ITEMS = 4          # most worklist items a work unit: raster_resolve.cu's UNIT (PERF.md)

launches = 0        # K1 launches (CPU reference calls are not counted)
tiles_launches = 0  # K5 launches


def _raster_body(coeff):
    """(C, 96, 10) coeffs + ok flag -> (C, 96, 9); invalid rows get
    l1c = -1e9 so no pixel is ever inside them."""
    ok = coeff[..., 9:10] > 0.5
    body = torch.where(ok, coeff[..., 0:9], 0.0)
    l1c = torch.where(ok[..., 0], body[..., 2], -1e9)
    return torch.cat([body[..., :2], l1c[..., None], body[..., 3:]], -1)


def build_tri_records(coeff):
    """(C, 96, 10) affine coeffs + ok flag -> (C, 96, 16) depth records:
    lanes 0:9 the raster planes, the rest zero."""
    body = _raster_body(coeff)
    pad = torch.zeros(body.shape[:-1] + (REC_LANES_DEPTH - 9,), dtype=torch.float32,
                      device=coeff.device)
    return torch.cat([body, pad], -1)


def build_full_records(coeff, tri_screen, tri_attr):
    """(C, 96, 128) records: lanes 0:9 raster planes, 16:64 the 16
    perspective attribute planes grouped [16 x | 16 y | 16 c] (planes 0..10
    numerators a/w, 11 = 1/w, 12 material id, 13..15 geometric normal)."""
    C = coeff.shape[0]
    dev = coeff.device
    body = _raster_body(coeff)
    l1x, l1y, l1c = coeff[..., 0], coeff[..., 1], coeff[..., 2]
    l2x, l2y, l2c = coeff[..., 3], coeff[..., 4], coeff[..., 5]
    iw = tri_screen[..., 3]
    a_iw = tri_attr[..., 0:11] * iw[..., None]
    vals = torch.cat([a_iw, iw[..., None]], -1)
    v0, v1, v2 = vals[..., 0, :], vals[..., 1, :], vals[..., 2, :]
    d1 = v1 - v0
    d2 = v2 - v0
    px_ = l1x[..., None] * d1 + l2x[..., None] * d2
    py_ = l1y[..., None] * d1 + l2y[..., None] * d2
    pc_ = v0 + l1c[..., None] * d1 + l2c[..., None] * d2
    mat = tri_attr[..., 0, 11]
    p0, p1, p2 = tri_attr[..., 0, 0:3], tri_attr[..., 1, 0:3], tri_attr[..., 2, 0:3]
    gn = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)
    z4 = torch.zeros((C, MAX_TRIS, 4), dtype=torch.float32, device=dev)
    planes = torch.cat([px_, z4, py_, z4, pc_, mat[..., None], gn], -1)
    pad0 = torch.zeros((C, MAX_TRIS, 16 - 9), dtype=torch.float32, device=dev)
    pad1 = torch.zeros((C, MAX_TRIS, REC_LANES - 64), dtype=torch.float32, device=dev)
    return torch.cat([body, pad0, planes, pad1], -1)


def _tile_start(work_tile, tiles: int):
    return torch.searchsorted(
        work_tile, torch.arange(tiles + 1, dtype=work_tile.dtype,
                                device=work_tile.device)).to(torch.int32)


def split_units(tile_start, unit_items: int):
    """The kernels' work units: each non-empty tile's worklist span
    [tile_start[t], tile_start[t+1]) cut into units of at most
    ``unit_items`` items. Returns (units, 4) int32 rows (tile, first item,
    items, units of the tile): the units of split tiles first, then the
    tiles of one unit, each group in tile order, the queue order of the
    kernels. The plain version of the plan the kernels' first launch makes
    (``plan_units``); empty tiles have no unit (the kernels clear them)."""
    dev = tile_start.device
    n = (tile_start[1:] - tile_start[:-1]).to(torch.int64)
    units = (n + unit_items - 1) // unit_items
    t = torch.repeat_interleave(torch.arange(n.shape[0], device=dev), units)
    k = torch.arange(t.shape[0], device=dev) - (torch.cumsum(units, 0) - units)[t]
    j0 = tile_start[t].to(torch.int64) + k * unit_items
    items = torch.clamp(n[t] - k * unit_items, max=unit_items)
    rows = torch.stack([t, j0, items, units[t]], -1).to(torch.int32)
    return rows[torch.argsort((units[t] == 1).to(torch.int8), stable=True)]


def plan_units(work_tile, *, tiles: int):
    """(tile_start (tiles + 1,) int32, units (n, 4) int32): the plan of a
    call, by the kernels' plan launch for CUDA tensors and by
    ``_tile_start`` and ``split_units`` at ``UNIT_ITEMS`` for CPU tensors."""
    if work_tile.device.type == "cpu":
        tile_start = _tile_start(work_tile, tiles)
        return tile_start, split_units(tile_start, UNIT_ITEMS)
    kernels.require(work_tile, "work_tile", torch.int32)
    lib = kernels.library()
    dev = work_tile.device
    tile_start = torch.empty((tiles + 1,), dtype=torch.int32, device=dev)
    units = torch.empty((_max_units(work_tile.shape[0], tiles, UNIT_ITEMS), 4),
                        dtype=torch.int32, device=dev)
    count = torch.empty((1,), dtype=torch.int32, device=dev)
    kernels.check(lib.hr_raster_plan(work_tile.data_ptr(), work_tile.shape[0], tiles,
                                     tile_start.data_ptr(), units.data_ptr(),
                                     count.data_ptr(), kernels.stream_handle(dev)),
                  "hr_raster_plan")
    return tile_start, units[:int(count)]


def _max_units(n_work: int, tiles: int, unit_items: int) -> int:
    """The most units n_work items over ``tiles`` tiles can make."""
    return max(1, min(n_work, -(-n_work // unit_items) + tiles))


_resident = {}    # device index -> resident CTAs on the card
_scratch = {}     # (device index, stream) -> _Scratch


class _Scratch:
    """The launches' device scratch on one stream: the plan (tile starts,
    units, count; rewritten by every launch) and the queue, the tiles' unit
    counters and the split tiles' merge keys, zeroed once and left at zero
    by every launch. Launches on one stream run one after another."""

    def __init__(self, device, tiles: int, max_units: int):
        self.tiles, self.max_units = tiles, max_units
        i32 = dict(dtype=torch.int32, device=device)
        self.tile_start = torch.empty((tiles + 1,), **i32)
        self.units = torch.empty((max_units, 4), **i32)
        self.count = torch.empty((1,), **i32)
        self.queue = torch.zeros((2,), **i32)
        self.done = torch.zeros((tiles,), **i32)
        self.keys = torch.zeros((tiles * PIX,), dtype=torch.int64, device=device)


def _scratch_for(device, stream, tiles: int, max_units: int) -> _Scratch:
    key = (device.index, stream)
    s = _scratch.get(key)
    if s is None or s.tiles < tiles or s.max_units < max_units:
        s = _Scratch(device, max(tiles, s.tiles if s else 0),
                     max(max_units, s.max_units if s else 0))
        _scratch[key] = s
    return s


def _resident_ctas(lib, device) -> int:
    if device.index not in _resident:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            kernels.check(lib.hr_raster_ctas_per_sm(ctypes.addressof(out)),
                          "hr_raster_ctas_per_sm")
        if out.value < 1:
            raise RuntimeError("the tile raster does not fit an SM")
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        _resident[device.index] = n_sm * out.value
    return _resident[device.index]


def _launch(fn, records, work_tile, work_slot, tiles, outs, extra):
    """The kernels' common launch (plan, then raster) on the scratch of the
    current stream, in as many CTAs as the card keeps resident."""
    lib = kernels.library()
    dev = records.device
    if records.data_ptr() % 16:
        raise ValueError("records must be 16-byte aligned")
    stream = kernels.stream_handle(dev)
    wcap = work_tile.shape[0]
    s = _scratch_for(dev, stream, tiles, _max_units(wcap, tiles, UNIT_ITEMS))
    err = getattr(lib, fn)(
        records.data_ptr(), work_tile.data_ptr(), work_slot.data_ptr(), wcap,
        s.tile_start.data_ptr(), s.units.data_ptr(), s.count.data_ptr(),
        *(t.data_ptr() for t in outs), s.keys.data_ptr(), s.done.data_ptr(), s.queue.data_ptr(),
        tiles, *extra, _resident_ctas(lib, dev), stream)
    kernels.check(err, fn)


def raster_resolve_tiles(records, work_tile, work_slot, *, tiles: int, tx: int,
                         ty0: int = 0):
    """Fused raster + attribute resolve over a tile-sorted worklist. Tile t
    covers frame pixel rows (t // tx + ty0) * 32 + [0, 32): ``ty0`` is a row
    band's first tile row.

    records (S, 32, 128) f32; work_tile, work_slot (Wcap,) int32 (padding:
    tile == tiles, slot == -1). Returns depth (T, 1024) f32, visid (T, 1024)
    int32 (chunk_slot * 32 + row, -1 = none), attrs (T, 16, 1024) f32: rows
    0:3 world pos, 3:6 shading normal, 6:8 uv, 8:11 prev world pos, 11
    material id, 12:15 geometric normal (unnormalized), 15 zero."""
    if records.device.type == "cpu":
        return raster_resolve_tiles_reference(records, work_tile, work_slot,
                                              tiles=tiles, tx=tx, ty0=ty0)
    return _raster_resolve_tiles_cuda(records, work_tile, work_slot,
                                      tiles=tiles, tx=tx, ty0=ty0)


def _raster_resolve_tiles_cuda(records, work_tile, work_slot, *, tiles, tx, ty0):
    global launches
    S = records.shape[0]
    kernels.require(records, "records", torch.float32, (S, TRI_CHUNK, REC_LANES))
    kernels.require(work_tile, "work_tile", torch.int32)
    kernels.require(work_slot, "work_slot", torch.int32, work_tile.shape)
    dev = records.device
    depth = torch.empty((tiles, PIX), dtype=torch.float32, device=dev)
    visid = torch.empty((tiles, PIX), dtype=torch.int32, device=dev)
    attrs = torch.empty((tiles, ATTR_ROWS, PIX), dtype=torch.float32, device=dev)
    _launch("hr_raster_resolve_tiles", records, work_tile, work_slot, tiles,
            (depth, visid, attrs), (tx, int(ty0)))
    launches += 1
    return depth, visid, attrs


def _plane_eval(A, oxf, oyf, xl, yl, k):
    """Plane k of rows A (..., R, >=k+3) at tile-local (xl, yl) (1, PIX):
    constants re-centred on the tile origin first, each step rounded."""
    a0, a1, a2 = A[..., k:k + 1], A[..., k + 1:k + 2], A[..., k + 2:k + 3]
    c = a0 * oxf + a1 * oyf + a2
    return a0 * xl + a1 * yl + c


def raster_resolve_tiles_reference(records, work_tile, work_slot, *, tiles: int,
                                   tx: int, ty0: int = 0):
    """Plain PyTorch version of the kernel (any device): loop 1 (max depth
    and winner id under the kernel's tie rules) is K5's plain version, loop
    2 evaluates the winner's attribute planes per pixel."""
    dev = records.device
    depth, visid = raster_tiles_reference(records, work_tile, work_slot, tiles=tiles, tx=tx,
                                          ty0=ty0)
    p_in = torch.arange(PIX, device=dev)
    # loop 2: each pixel's winner row, 16 perspective-correct planes
    flat = records.reshape(-1, records.shape[-1])
    vid = visid.reshape(-1).to(torch.int64)
    won = vid >= 0
    cof = flat[vid.clamp(min=0)][:, 16:64]                    # (T*PIX, 48)
    t_of = torch.arange(tiles, device=dev).repeat_interleave(PIX)
    p_of = p_in.repeat(tiles)
    pxg = ((p_of % TILE).to(torch.float32)
           + ((t_of % tx) * TILE).to(torch.float32) + 0.5)[:, None]
    pyg = ((p_of // TILE).to(torch.float32)
           + ((t_of // tx + ty0) * TILE).to(torch.float32) + 0.5)[:, None]
    vals = cof[:, 0:16] * pxg + cof[:, 16:32] * pyg + cof[:, 32:48]
    inv_w = 1.0 / torch.clamp(vals[:, 11:12], min=1e-12)
    out = torch.cat([vals[:, 0:11] * inv_w, vals[:, 12:16],
                     torch.zeros_like(vals[:, :1])], -1)
    out = torch.where(won[:, None], out, 0.0)
    attrs = out.reshape(tiles, PIX, ATTR_ROWS).permute(0, 2, 1).contiguous()
    return depth, visid, attrs


def raster_tiles(records, work_tile, work_slot, *, tiles: int, tx: int, ty0: int = 0,
                 depth_only: bool = False):
    """Tile raster without attributes over a tile-sorted worklist (K5);
    ``ty0`` as in raster_resolve_tiles.

    records (S, 32, lanes >= 9) f32, only lanes 0:9 read; work_tile,
    work_slot (Wcap,) int32 (padding: tile == tiles). Returns depth (T, 1024)
    f32 and visid (T, 1024) int32 (slot * 32 + row; -1 everywhere when
    ``depth_only``)."""
    if records.device.type == "cpu":
        return raster_tiles_reference(records, work_tile, work_slot, tiles=tiles,
                                      tx=tx, ty0=ty0, depth_only=depth_only)
    return _raster_tiles_cuda(records, work_tile, work_slot, tiles=tiles, tx=tx, ty0=ty0,
                              depth_only=depth_only)


def _raster_tiles_cuda(records, work_tile, work_slot, *, tiles, tx, ty0, depth_only):
    global tiles_launches
    S, _, lanes = records.shape
    if lanes < 12 or lanes % 4:
        raise ValueError(f"the kernel takes records of 12, 16, 20, ... lanes, got {lanes}")
    kernels.require(records, "records", torch.float32, (S, TRI_CHUNK, lanes))
    kernels.require(work_tile, "work_tile", torch.int32)
    kernels.require(work_slot, "work_slot", torch.int32, work_tile.shape)
    dev = records.device
    depth = torch.empty((tiles, PIX), dtype=torch.float32, device=dev)
    visid = torch.empty((tiles, PIX), dtype=torch.int32, device=dev)
    _launch("hr_raster_tiles", records, work_tile, work_slot, tiles,
            (depth, visid), (tx, int(ty0), lanes, int(bool(depth_only))))
    tiles_launches += 1
    return depth, visid


def _rows_outside(A, oxf, oyf):
    """(m, 32) rows that cannot cover any pixel of their item's tile: at
    some tile corner test l1 >= 0, l2 >= 0 or l1 + l2 <= 1 fails in exact
    arithmetic (float64 at the corners, where an affine plane takes its
    extremes over the tile) by more than 1e-5 of the plane's magnitude, far
    beyond the rounding of the kernel's f32 evaluation. Invalid rows (l1c =
    -1e9) are among them."""
    A = A.to(torch.float64)
    X = torch.cat([oxf, oxf + (TILE - 1)], -1).to(torch.float64)     # (m, 1, 2)
    Y = torch.cat([oyf, oyf + (TILE - 1)], -1).to(torch.float64)

    def extremes(a0, a1, a2):
        px, py = a0 * X, a1 * Y
        mag = (torch.abs(a0) * torch.abs(X).amax(-1, keepdim=True)
               + torch.abs(a1) * torch.abs(Y).amax(-1, keepdim=True) + torch.abs(a2))
        return (a2 + px.amin(-1, keepdim=True) + py.amin(-1, keepdim=True),
                a2 + px.amax(-1, keepdim=True) + py.amax(-1, keepdim=True), mag)

    _, hi1, m1 = extremes(A[..., 0:1], A[..., 1:2], A[..., 2:3])
    _, hi2, m2 = extremes(A[..., 3:4], A[..., 4:5], A[..., 5:6])
    lo_s, _, _ = extremes(A[..., 0:1] + A[..., 3:4], A[..., 1:2] + A[..., 4:5],
                          A[..., 2:3] + A[..., 5:6])
    out = ((hi1 < -1e-5 * m1) | (hi2 < -1e-5 * m2)
           | (lo_s > 1.0 + 1e-5 * (m1 + m2) + 1e-6))
    return out[..., 0]


def _rows_outside_strips(A, oxf, oyf):
    """(m, 32 rows, 32 strips): row r of item i cannot cover any pixel of
    pixel row s of its tile (the 32x1 strip x in [oxf, oxf + 31], y = oyf +
    s): at an end of the strip l1 >= 0, l2 >= 0 or l1 + l2 <= 1 fails in
    float64 by more than 1e-5 of the plane's magnitude, the margin of
    ``_rows_outside`` applied to a strip. The kernels' warp test, step for
    step, the parts that do not depend on y first; tile coordinates are
    positive, so x = oxf + 31 is the largest |x|. A (m, 32, >=6) rows;
    oxf, oyf (m, 1, 1)."""
    A = A.to(torch.float64)
    x0 = oxf.to(torch.float64)
    x1 = x0 + (TILE - 1)
    y = oyf.to(torch.float64) + torch.arange(TILE, dtype=torch.float64, device=A.device)
    a0, a1, a2 = A[..., 0:1], A[..., 1:2], A[..., 2:3]
    b0, b1, b2 = A[..., 3:4], A[..., 4:5], A[..., 5:6]
    s0, s1, s2 = a0 + b0, a1 + b1, a2 + b2
    hx1 = a2 + torch.maximum(a0 * x0, a0 * x1)
    mx1 = torch.abs(a0) * x1 + torch.abs(a2)
    hx2 = b2 + torch.maximum(b0 * x0, b0 * x1)
    mx2 = torch.abs(b0) * x1 + torch.abs(b2)
    lxs = s2 + torch.minimum(s0 * x0, s0 * x1)
    m1 = mx1 + torch.abs(a1) * y
    m2 = mx2 + torch.abs(b1) * y
    return ((hx1 + a1 * y < -1e-5 * m1) | (hx2 + b1 * y < -1e-5 * m2)
            | (lxs + s1 * y > (1.0 + 1e-5 * (m1 + m2)) + 1e-6))


def raster_tiles_reference(records, work_tile, work_slot, *, tiles: int, tx: int,
                           ty0: int = 0, depth_only: bool = False):
    """Plain PyTorch version of K5 (any device). Walks the worklist in
    batches of items, whatever their tiles, so empty tiles cost nothing, and
    evaluates only the rows that can reach their tile (``_rows_outside``
    leaves out the others, which no pixel could count as inside). Each
    evaluated row's plane arithmetic is the kernel's; a batch reduces its
    items per tile (max depth; the first item reaching it keeps the id, and
    the lowest row inside it), and a tile takes a batch's result only where
    it is strictly deeper than what earlier batches left, the kernel's
    strict > across items."""
    dev = records.device
    rows = records.shape[1]
    n = int(_tile_start(work_tile, tiles)[-1])
    p_in = torch.arange(PIX, device=dev)
    xl = (p_in % TILE).to(torch.float32)[None, :]
    yl = (p_in // TILE).to(torch.float32)[None, :]
    z_acc = torch.zeros((tiles, PIX), dtype=torch.float32, device=dev)
    id_acc = torch.full((tiles, PIX), -1, dtype=torch.int64, device=dev)
    for b0 in range(0, n, REF_ITEM_BATCH):
        t_b = work_tile[b0:min(n, b0 + REF_ITEM_BATCH)].to(torch.int64)
        m = t_b.shape[0]
        slots = work_slot[b0:b0 + m].to(torch.int64)
        A = records[slots][..., 0:9]                           # (m, 32, 9)
        oxf = ((t_b % tx) * TILE).to(torch.float32)[:, None, None] + 0.5
        oyf = ((t_b // tx + ty0) * TILE).to(torch.float32)[:, None, None] + 0.5
        ki, kr = torch.nonzero(~_rows_outside(A, oxf, oyf), as_tuple=True)
        Ak, oxk, oyk = A[ki, kr], oxf[ki, 0], oyf[ki, 0]       # (K, 9), (K, 1)
        l1 = _plane_eval(Ak, oxk, oyk, xl, yl, 0)              # (K, PIX)
        l2 = _plane_eval(Ak, oxk, oyk, xl, yl, 3)
        z = _plane_eval(Ak, oxk, oyk, xl, yl, 6)
        zm = torch.where((l1 >= 0.0) & (l2 >= 0.0) & (l1 + l2 <= 1.0), z, -1.0)
        ki_e = ki[:, None].expand(-1, PIX)
        best = torch.full((m, PIX), -1.0, device=dev).scatter_reduce(0, ki_e, zm, "amax")
        uniq, inv = torch.unique_consecutive(t_b, return_inverse=True)
        inv_e = inv[:, None].expand(-1, PIX)
        m_t = torch.full((uniq.shape[0], PIX), -2.0, device=dev).scatter_reduce(
            0, inv_e, best, "amax")                            # per-tile max
        z_prev = z_acc[uniq]
        upd = m_t > z_prev
        z_acc[uniq] = torch.where(upd, m_t, z_prev)
        if depth_only:
            continue
        # lowest row reaching its item's max (rows left out never reach a
        # max above -1, the only maxima that can win)
        brow = torch.full((m, PIX), rows, device=dev).scatter_reduce(
            0, ki_e, torch.where(zm == best[ki], kr[:, None], rows), "amin")
        item = torch.where(best == m_t[inv], torch.arange(m, device=dev)[:, None], m)
        first = torch.full((uniq.shape[0], PIX), m, device=dev).scatter_reduce(
            0, inv_e, item, "amin").clamp(max=m - 1)
        gid = slots[first] * rows + brow.gather(0, first)
        id_acc[uniq] = torch.where(upd & (m_t > 0.0), gid, id_acc[uniq])
    depth = torch.clamp(z_acc, min=0.0)
    visid = torch.where(z_acc > 0.0, id_acc, -1).to(torch.int32)
    return depth, visid
