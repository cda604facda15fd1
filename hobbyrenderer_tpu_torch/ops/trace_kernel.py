"""Closest hit of sorted 1024-ray blocks: the CUDA kernel's wrapper and its
plain PyTorch version (counterpart of hobbyrenderer_tpu/ops/trace.py::
closest_hit_blocks and its Pallas body ``_closest_kernel``, K6).

Per block of 1024 rays [ox oy oz dx dy dz tmax act] the walk is a beam BFS of
the 4-wide BVH held in ``beam_table`` rows: the block's origin box and
direction box (min / max over its active lanes) give each child box an
interval test, levels run in order, each level's nodes in groups of 8 rows,
children are appended to the next level in (row, child) order, at most
FCAP - 1 = 4,095 nodes a level (children past that are dropped and set the
block's overflow flag). Before each group the cull bound ``cur_hi``, the
largest best t over the active lanes, is read once; a child whose beam
interval starts later is skipped. Leaf rows fold their 4 triangle records
into every active lane's best (t, tri, u, v, front) by Möller-Trumbore: per
record slot a lane takes the smallest t over the group's leaf rows, and tri,
u, v and front are each the largest over the rows that tie at it.

``closest_hit_blocks`` launches csrc/closest_blocks.cu for CUDA tensors and
runs ``closest_hit_blocks_reference`` for CPU tensors; nothing else chooses.
Both keep the Pallas kernel's rounding (every product and sum a separate op,
IEEE division), so they agree bit for bit. The kernel runs a level's box
tests at once under the level's first cur_hi, spreads a block's lanes over
a cluster of ``CLUSTER`` CTAs and skips only record tests whose h is
certain to be false (csrc/closest_blocks.cu); it tells leaf rows from
interior ones by id (rows >= ``_leaf_start``), as ``beam_table`` marks
them, so the table must be ``beam_table``'s. The three differ where a
lane's t_max exceeds BIG (3e37), where a hit's t may too: callers cap t_max
at TMAX_CAP = 1e30 (ops/trace.py)."""

from __future__ import annotations

import torch

from hobbyrenderer_tpu_torch import kernels
from hobbyrenderer_tpu_torch.ops.beam import _leaf_start

PIX = 1024        # rays per block
GW = 8            # node rows per group
FCAP = 4096       # frontier capacity per level (nodes kept: FCAP - 1)
BIG = 3.0e37
EPS = 1e-8
# fp32 operations of one Möller-Trumbore record test as the kernel does it
# (2 cross products p and q of 9 ops, 4 dot products det, u, v and t of 5,
# 3 scalings by 1/det, 1 division, 3 subtractions, u + v and 8 comparisons),
# for the operation bound
MT_OPS = 2 * 9 + 4 * 5 + 3 + 1 + 3 + 1 + 8
# fp32 operations of one interval child-box test (3 axes of 2 subtractions,
# 4 products, 6 min/max, 2 selects, 2 products, 2 sums, 3 comparisons)
BOX_OPS = 3 * 21
# fp32 operations of the kernel's warp bound of one record (record_may_hit:
# p and q 30 each, det and t's numerator 16 each, s 6, u's and v's
# numerators 34 each, 16 comparisons)
IV_OPS = 2 * 30 + 2 * 16 + 6 + 2 * 34 + 16

CLUSTER = 4       # the kernel's CTAs a block, 256 lanes each (csrc/closest_blocks.cu)

launches = 0      # kernel launches (CPU reference calls are not counted)


def closest_hit_blocks(btable, rays, t_min: float = 1e-4, work: dict = None):
    """rays (T, 8, 1024) f32 [ox oy oz dx dy dz tmax act], btable (N, 128)
    f32 from ``beam_table`` -> (t, tri, u, v, front) (T, 1024) f32 each
    (t = tmax and tri = -1 on a miss) and the overflow flags (T,) f32.
    ``work``, if given to a CUDA call, gets the
    kernel's counts (a host sync): ``record_tests`` (lane record tests it
    ran), ``records_culled`` (lane record tests its warp cull skipped) and
    ``record_bounds`` (the cull's record bounds, one a warp and record)."""
    if rays.device.type == "cpu":
        return closest_hit_blocks_reference(btable, rays, t_min)
    return _closest_hit_blocks_cuda(btable, rays, t_min, work)


def _closest_hit_blocks_cuda(btable, rays, t_min, work):
    global launches
    T = rays.shape[0]
    kernels.require(rays, "rays", torch.float32, (T, 8, PIX))
    kernels.require(btable, "btable", torch.float32, (btable.shape[0], 128))
    if btable.device != rays.device:
        raise ValueError("btable and rays must be on the same device")
    if btable.data_ptr() % 16:
        raise ValueError("btable must be 16-byte aligned (its rows are copied in bulk)")
    lib = kernels.library()
    outs = [torch.empty((T, PIX), dtype=torch.float32, device=rays.device) for _ in range(5)]
    ovf = torch.empty((T,), dtype=torch.float32, device=rays.device)
    counts = None if work is None else torch.zeros((3,), dtype=torch.int64, device=rays.device)
    N = btable.shape[0]
    err = lib.hr_closest_hit_blocks(rays.data_ptr(), btable.data_ptr(),
                                    *[o.data_ptr() for o in outs], ovf.data_ptr(),
                                    None if counts is None else counts.data_ptr(), T, N,
                                    _leaf_start(N), float(t_min),
                                    kernels.stream_handle(rays.device))
    kernels.check(err, "hr_closest_hit_blocks")
    launches += 1
    if counts is not None:
        work.update(zip(("record_tests", "records_culled", "record_bounds"), counts.tolist()))
    return (*outs, ovf)


def max_clusters() -> int:
    """How many of the kernel's clusters one card holds at once."""
    import ctypes
    n = ctypes.c_int(0)
    kernels.check(kernels.library().hr_closest_hit_blocks_max_clusters(ctypes.byref(n)),
                  "hr_closest_hit_blocks_max_clusters")
    return n.value


def _beam_bounds(o, d, act):
    """Per block: origin box, direction box and interval scales (T, 3)."""
    big = torch.tensor(BIG, dtype=torch.float32, device=o.device)
    olo = torch.where(act[:, None], o, big).amin(-1)
    ohi = torch.where(act[:, None], o, -big).amax(-1)
    dlo = torch.where(act[:, None], d, big).amin(-1)
    dhi = torch.where(act[:, None], d, -big).amax(-1)
    pos = dlo > EPS
    neg = dhi < -EPS
    ilo = torch.where(pos, 1.0 / torch.clamp(dhi, min=EPS), 1.0 / torch.clamp(dlo, max=-EPS))
    ihi = torch.where(pos, 1.0 / torch.clamp(dlo, min=EPS), 1.0 / torch.clamp(dhi, max=-EPS))
    return olo, ohi, dlo, dhi, pos | neg, ilo, ihi


def _child_hits(B, rowok, isleaf, cur_hi, bb):
    """Interval tests of the 4 child boxes of each row: (T, 8, 4) bool."""
    olo, ohi, dlo, dhi, ivalid, ilo, ihi = bb
    c = cur_hi[:, None, None]
    box = B[..., :24].reshape(B.shape[0], GW, 4, 6)
    t_en = torch.zeros_like(box[..., 0])
    t_ex = c.expand_as(t_en)
    ok = torch.ones_like(t_en, dtype=torch.bool)
    for a in range(3):
        blo, bhi = box[..., a], box[..., 3 + a]
        ok = ok & (blo <= bhi)
        s = lambda x: x[:, a, None, None]        # noqa: E731 (per-block scalar)
        p_lo = blo - s(ohi)
        p_hi = bhi - s(olo)
        c1, c2 = p_lo * s(ilo), p_lo * s(ihi)
        c3, c4 = p_hi * s(ilo), p_hi * s(ihi)
        lo4 = torch.minimum(torch.minimum(c1, c2), torch.minimum(c3, c4))
        hi4 = torch.maximum(torch.maximum(c1, c2), torch.maximum(c3, c4))
        iv = s(ivalid)
        t_en = torch.where(iv, torch.maximum(t_en, lo4), t_en)
        t_ex = torch.where(iv, torch.minimum(t_ex, hi4), t_ex)
        reach_lo = s(olo) + torch.clamp(s(dlo), max=0.0) * c
        reach_hi = s(ohi) + torch.clamp(s(dhi), min=0.0) * c
        ok = ok & (iv | ((reach_hi >= blo) & (reach_lo <= bhi)))
    return ok & (t_en <= t_ex) & (t_ex > 0.0) & (rowok & ~isleaf)[..., None]


def _leaf_fold(B, isleaf, ray, best, t_min):
    """Fold the group's leaf records into the per-lane best hits, in place
    on ``best`` = [t, tri, u, v, front] (T, 1024) each."""
    ox, oy, oz, dx, dy, dz, tmax, act = (ray[:, i, None, :] for i in range(8))
    act = act > 0.5
    big = torch.tensor(BIG, dtype=torch.float32, device=B.device)
    neg_big = -big
    one_eps = torch.tensor(1.0 + 1e-7, dtype=torch.float32, device=B.device)
    lf = isleaf[..., None]
    for k in range(4):
        r = B[..., 16 * k:16 * k + 10, None]                 # (T, 8, 10, 1)
        v0x, v0y, v0z = r[:, :, 0], r[:, :, 1], r[:, :, 2]
        e1x, e1y, e1z = r[:, :, 3], r[:, :, 4], r[:, :, 5]
        e2x, e2y, e2z = r[:, :, 6], r[:, :, 7], r[:, :, 8]
        tid = r[:, :, 9]
        px = dy * e2z - dz * e2y                             # (T, 8, 1024)
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        okd = torch.abs(det) > 1e-12
        inv_det = torch.where(okd, 1.0 / det, 0.0)
        sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
        u = (sx * px + sy * py + sz * pz) * inv_det
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        vv = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        bt = best[0][:, None, :]
        hit = (okd & (u >= -1e-7) & (vv >= -1e-7) & (u + vv <= one_eps) & (t > t_min)
               & (t < tmax) & (t < bt) & (tid >= 0.0) & lf & act)
        m = torch.where(hit, t, big).amin(1)                 # (T, 1024)
        upd = hit.any(1)
        sel = hit & (t == m[:, None, :])

        def pick(attr):
            return torch.where(sel, attr, neg_big).amax(1)
        front = torch.where(det > 0, 1.0, 0.0)
        new = (m, pick(tid.expand_as(t)), pick(u), pick(vv), pick(front))
        for i in range(5):
            best[i] = torch.where(upd, new[i], best[i])


def closest_hit_blocks_reference(btable, rays, t_min: float = 1e-4, stats: dict = None):
    """Plain PyTorch version (any device): every block's BFS in lockstep,
    group by group (a block whose level has fewer groups idles), with the
    kernel's visiting order and arithmetic. ``stats``, if given, gets the
    work this run's data needed: ``rows`` (block, node row) visits,
    ``leaf_rows``, ``leaf_lane_rows`` (leaf rows times the block's active
    lanes), ``box_tests``, ``levels`` (of the deepest block),
    ``max_block_rows`` (the rows of the block that reads the most) and
    ``max_block_leaf_rows``."""
    T = rays.shape[0]
    dev = rays.device
    o, d = rays[:, 0:3], rays[:, 3:6]
    act = rays[:, 7] > 0.5
    best = [rays[:, 6].clone(), torch.full((T, PIX), -1.0, device=dev),
            torch.zeros((T, PIX), device=dev), torch.zeros((T, PIX), device=dev),
            torch.zeros((T, PIX), device=dev)]
    ovf = torch.zeros(T, dtype=torch.bool, device=dev)
    bb = _beam_bounds(o, d, act)
    n_act = act.sum(1)
    frontier = torch.zeros((T, FCAP), dtype=torch.int64, device=dev)
    cnt = (n_act > 0).to(torch.int64)
    rows_n = leaf_n = leaf_lanes = box_n = levels = 0
    rows_blk = torch.zeros(T, dtype=torch.int64, device=dev)
    leaf_blk = torch.zeros(T, dtype=torch.int64, device=dev)
    rowi = torch.arange(GW, device=dev)
    chi = torch.arange(4, device=dev)
    tix = torch.arange(T, device=dev)
    while True:
        n_groups = int((cnt.max() + GW - 1) // GW)      # one host read per level
        if n_groups == 0:
            break
        levels += 1
        nxt = torch.zeros_like(frontier)
        cnt_nxt = torch.zeros_like(cnt)
        for g in range(n_groups):
            rem = torch.clamp(cnt - g * GW, 0, GW)
            rowok = rowi[None, :] < rem[:, None]               # (T, 8)
            nid = frontier[:, g * GW:(g + 1) * GW]
            B = torch.where(rowok[..., None], btable[nid], 0.0)  # (T, 8, 128)
            isleaf = (B[..., 127] > 0.5) & rowok
            cur_hi = torch.where(act, best[0], 0.0).amax(1)
            hits = _child_hits(B, rowok, isleaf, cur_hi, bb).reshape(T, 4 * GW)
            pos = cnt_nxt[:, None] + torch.cumsum(hits.to(torch.int64), 1) - 1
            keep = hits & (pos < FCAP - 1)
            ovf = ovf | (hits & (pos >= FCAP - 1)).any(1)
            child = (4 * nid[..., None] + 1 + chi).reshape(T, 4 * GW)
            bi = tix[:, None].expand_as(keep)
            nxt[bi[keep], pos[keep]] = child[keep]
            cnt_nxt = torch.clamp(cnt_nxt + hits.sum(1), max=FCAP - 1)
            _leaf_fold(B, isleaf, rays, best, t_min)
            if stats is not None:
                rows_n += rem.sum()
                rows_blk += rem
                nl = isleaf.sum(1)
                leaf_blk += nl
                leaf_n += nl.sum()
                leaf_lanes += (nl * n_act).sum()
                box_n += 4 * (rowok & ~isleaf).sum()
        frontier, cnt = nxt, cnt_nxt
    if stats is not None:
        stats.update(rows=int(rows_n), leaf_rows=int(leaf_n), leaf_lane_rows=int(leaf_lanes),
                     box_tests=int(box_n), levels=levels,
                     max_block_rows=int(rows_blk.max()) if T else 0,
                     max_block_leaf_rows=int(leaf_blk.max()) if T else 0)
    return (*best, ovf.to(torch.float32))
