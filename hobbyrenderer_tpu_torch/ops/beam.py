"""Any-hit occlusion of coherent ray tiles: the CUDA kernel's wrapper, its
plain PyTorch version, and the tile packing around them.

Counterpart of hobbyrenderer_tpu/ops/beam.py (K4, beam_any_hit_tiles). The
kernel source is csrc/beam_any_hit.cu. ``beam_any_hit_tiles`` launches the
kernel for CUDA tensors and runs ``beam_any_hit_tiles_reference`` for CPU
tensors; nothing else chooses."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hobbyrenderer_tpu_torch import kernels
from hobbyrenderer_tpu_torch.ops.intersect import safe_inv_dir

TILE = 32
PIX = TILE * TILE
# batch sizes of the plain version (memory per step, not results)
REF_TRI_CHUNK = 256      # triangles per bounding-box chunk
REF_RAY_CHUNK = 4096     # rays per box-cull step
REF_PAIR_BATCH = 8192    # (ray, chunk) pairs per Möller-Trumbore step
STACK = 64               # entries of the kernel's per-lane stack (check_stack)

launches = 0      # kernel launches (CPU reference calls are not counted)
_counters = {}    # (device index, stream) -> the kernel's counters, left at zero


def beam_table(table) -> torch.Tensor:
    """BVH table (I+L, 40) -> beam layout (I+L, 128) f32 on the table's
    device (a numpy table gives a CPU tensor): interior rows carry the 4
    child boxes in lanes 0:24, leaf rows 4 x 16-lane triangle records
    [v0 e1 e2 tid pad6], lane 127 is the leaf marker."""
    table = torch.as_tensor(table, dtype=torch.float32)
    n, w = table.shape
    assert w == 40, "beam_table expects 4-wide unified rows"
    tris = table.reshape(n, 4, 10)
    leaf64 = torch.cat([tris, tris.new_zeros((n, 4, 6))], -1).reshape(n, 64)
    interior64 = torch.cat([table[:, :24], table.new_zeros((n, 40))], -1)
    is_leaf = (torch.arange(n, device=table.device) >= _leaf_start(n))[:, None]
    body = torch.where(is_leaf, leaf64, interior64)
    return torch.cat([body, table.new_zeros((n, 63)), is_leaf.to(torch.float32)], -1)


def pack_rays_tiles(o, d, t_max, active, H: int, W: int):
    """(H, W, 3) origins/dirs + (H, W) t_max/active -> (T, 8, 1024) ray
    blocks in 32x32 tile order (framebuffer padded up to whole tiles)."""
    ty = -(-H // TILE)
    tx = -(-W // TILE)
    Hp, Wp = ty * TILE, tx * TILE
    packed = torch.cat([o, d, t_max[..., None],
                        active.to(torch.float32)[..., None]], -1)
    packed = F.pad(packed, (0, 0, 0, Wp - W, 0, Hp - H), value=0.0)
    packed = packed.reshape(ty, TILE, tx, TILE, 8).permute(0, 2, 4, 1, 3)
    return packed.reshape(ty * tx, 8, PIX).contiguous()


def unpack_tiles(img_t, H: int, W: int):
    """(T, 1024) tile order -> (H, W)."""
    ty = -(-H // TILE)
    tx = -(-W // TILE)
    out = img_t.reshape(ty, tx, TILE, TILE).permute(0, 2, 1, 3)
    return out.reshape(ty * TILE, tx * TILE)[:H, :W]


def beam_any_hit_tiles(btable, rays):
    """rays (T, 8, 1024) f32 [ox oy oz dx dy dz tmax act], btable (N, 128)
    f32 -> occluded (T, 1024) f32 (1 = hit), overflow flags (T,) f32. Raises
    for a table deeper than the kernel's stack can walk (``check_stack``)."""
    check_stack(btable.shape[0])
    if rays.device.type == "cpu":
        return beam_any_hit_tiles_reference(btable, rays)
    return _beam_any_hit_tiles_cuda(btable, rays)


def _beam_any_hit_tiles_cuda(btable, rays):
    global launches
    T = rays.shape[0]
    kernels.require(rays, "rays", torch.float32, (T, 8, PIX))
    kernels.require(btable, "btable", torch.float32, (btable.shape[0], 128))
    if btable.device != rays.device:
        raise ValueError("btable and rays must be on the same device")
    lib = kernels.library()
    occ = torch.empty((T, PIX), dtype=torch.float32, device=rays.device)
    ovf = torch.empty((T,), dtype=torch.float32, device=rays.device)
    lanes = torch.empty((T * PIX,), dtype=torch.int32, device=rays.device)
    err = lib.hr_beam_any_hit_tiles(rays.data_ptr(), btable.data_ptr(),
                                    occ.data_ptr(), ovf.data_ptr(), lanes.data_ptr(),
                                    counters(rays.device).data_ptr(), T,
                                    btable.shape[0], _leaf_start(btable.shape[0]),
                                    kernels.stream_handle(rays.device))
    kernels.check(err, "hr_beam_any_hit_tiles")
    launches += 1
    return occ, ovf


def counters(device) -> torch.Tensor:
    """The kernel's counters (live lanes, packet queue, CTAs done) on this
    device's current stream: zeroed once; each launch leaves them at zero,
    and launches on one stream run one after another."""
    key = (device.index, kernels.stream_handle(device))
    if key not in _counters:
        _counters[key] = torch.zeros((3,), dtype=torch.int32, device=device)
    return _counters[key]


def tile_majority_mask(key, H: int, W: int, probes: int = 8, exclude: int = None):
    """(H, W) integer keys -> bool (H, W): lanes that match their 32x32
    tile's approximate modal key, the mode estimated by counting the
    matches of ``probes`` evenly spaced lanes (beam.py:370-402). ``exclude``
    is a sentinel key that is never elected nor matched."""
    ty = -(-H // TILE)
    tx = -(-W // TILE)
    kp = F.pad(key, (0, tx * TILE - W, 0, ty * TILE - H), value=-(2 ** 30))
    t = kp.reshape(ty, TILE, tx, TILE).permute(0, 2, 1, 3).reshape(ty * tx, PIX)
    cand = t[:, ::PIX // probes][:, :probes]                       # (T, P)
    cnt = torch.sum(t[:, None, :] == cand[:, :, None], -1)        # (T, P)
    if exclude is not None:
        cnt = torch.where(cand == exclude, -1, cnt)
    rep = torch.gather(cand, 1, torch.argmax(cnt, -1)[:, None])
    m = t == rep
    if exclude is not None:
        m = m & (rep != exclude)
    return unpack_tiles(m, H, W)


def leaf_triangles(btable):
    """The btable's real leaf triangles as (M, 9) [v0 e1 e2], in leaf order."""
    leaf = btable[:, 127] > 0.5
    recs = btable[leaf][:, :64].reshape(-1, 16)
    return recs[recs[:, 9] >= 0.0][:, :9].contiguous()


def _mt_any(o, d, tmax, tri):
    """Möller-Trumbore any-hit of rays (R, 3) against triangles (R or 1,
    K, 9) [v0 e1 e2] with the thresholds of beam.py:193-204, each step
    rounded like the kernel. Returns (R,) bool."""
    ox, oy, oz = (o[:, i:i + 1] for i in range(3))
    dx, dy, dz = (d[:, i:i + 1] for i in range(3))
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (tri[..., i] for i in range(9))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, 1.0 / det, 0.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = (sx * px + sy * py + sz * pz) * inv_det
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    vv = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    one_eps = torch.tensor(1.0 + 1e-7, dtype=torch.float32, device=o.device)
    hit = (ok & (u >= -1e-7) & (vv >= -1e-7) & (u + vv <= one_eps)
           & (t > 1e-4) & (t < tmax[:, None]))
    return hit.any(dim=1)


def beam_any_hit_tiles_reference(btable, rays):
    """Plain PyTorch version (any device): brute-force Möller-Trumbore of
    every active ray against the table's leaf triangles — it does not walk
    the BVH. Triangles go in chunks of REF_TRI_CHUNK in leaf order (which
    keeps a chunk spatially compact), and a (ray, chunk) pair is tested only
    when the ray meets the chunk's padded bounding box: a conservative cull
    that saves work and changes no result. Overflow flags are zero."""
    T = rays.shape[0]
    dev = rays.device
    r = rays.permute(0, 2, 1).reshape(-1, 8)
    o, d, tmax = r[:, 0:3], r[:, 3:6], r[:, 6]
    act = (r[:, 7] > 0.5) & (tmax > 1e-4)
    occ = torch.zeros(r.shape[0], dtype=torch.bool, device=dev)
    zeros_t = torch.zeros(T, device=dev)
    tri = leaf_triangles(btable)
    M = tri.shape[0]
    if M == 0:
        return occ.reshape(T, PIX).to(torch.float32), zeros_t
    n_ch = -(-M // REF_TRI_CHUNK)
    # padding triangles are all zero: det = 0, never a hit
    chunks = F.pad(tri, (0, 0, 0, n_ch * REF_TRI_CHUNK - M)).reshape(n_ch, REF_TRI_CHUNK, 9)
    v0 = chunks[..., 0:3]
    verts = torch.stack([v0, v0 + chunks[..., 3:6], v0 + chunks[..., 6:9]], 2)
    real = (torch.arange(n_ch * REF_TRI_CHUNK, device=dev) < M).reshape(n_ch, REF_TRI_CHUNK)
    verts_lo = torch.where(real[..., None, None], verts, float("inf"))
    verts_hi = torch.where(real[..., None, None], verts, float("-inf"))
    lo = verts_lo.reshape(n_ch, -1, 3).amin(1)
    hi = verts_hi.reshape(n_ch, -1, 3).amax(1)
    pad = 1e-4 * torch.clamp(torch.maximum(lo.abs(), hi.abs()), min=1.0)
    lo, hi = lo - pad, hi + pad
    inv = safe_inv_dir(d)
    idx_act = torch.nonzero(act).flatten()
    for r0 in range(0, idx_act.shape[0], REF_RAY_CHUNK):
        ri = idx_act[r0:r0 + REF_RAY_CHUNK]
        ro, rd, rinv, rt = o[ri], d[ri], inv[ri], tmax[ri]
        t0 = (lo[None] - ro[:, None]) * rinv[:, None]
        t1 = (hi[None] - ro[:, None]) * rinv[:, None]
        tn = torch.clamp(torch.minimum(t0, t1).amax(-1), min=0.0)
        tf = torch.minimum(torch.maximum(t0, t1).amin(-1), rt[:, None])
        pr, pc = torch.nonzero(tn <= tf, as_tuple=True)       # (ray, chunk) pairs
        hits = torch.zeros(ri.shape[0], dtype=torch.int32, device=dev)
        for p0 in range(0, pr.shape[0], REF_PAIR_BATCH):
            rr, cc = pr[p0:p0 + REF_PAIR_BATCH], pc[p0:p0 + REF_PAIR_BATCH]
            h = _mt_any(ro[rr], rd[rr], rt[rr], chunks[cc])
            hits.index_add_(0, rr, h.to(torch.int32))
        occ[ri] = hits > 0
    return occ.reshape(T, PIX).to(torch.float32), zeros_t


def packet_order(device=None):
    """(1024,) int64: the tile lane of each position in the kernel's packet
    order: 8x4 pixel blocks, the blocks row by row. A tile's live lanes are
    listed in this order, so a full packet of 32 is a square-ish patch of
    neighbouring pixels (rays that visit the same rows)."""
    j = torch.arange(PIX, device=device)
    b, i = j // 32, j % 32
    x = (b % 4) * 8 + i % 8
    y = (b // 4) * 4 + i // 8
    return y * TILE + x


def live_lanes(rays):
    """The kernel's list of live lanes: (T, 8, 1024) rays -> (L,) int64
    indices into the flattened (T * 1024) lanes of the lanes with act > 0.5
    and t_max > 1e-4, each tile's in ``packet_order``. Tiles come in tile
    order here; the kernel appends them in whatever order its CTAs run."""
    order = packet_order(rays.device)
    live = ((rays[:, 7] > 0.5) & (rays[:, 6] > 1e-4))[:, order]            # (T, 1024)
    t, j = torch.nonzero(live, as_tuple=True)
    return t * PIX + order[j]


def tree_depth(n_rows: int) -> int:
    """Levels of the implicit 4-wide heap of n_rows rows (level k holds rows
    (4^k - 1)/3 .. (4^(k+1) - 1)/3 - 1)."""
    d, full = 0, 0
    while full < n_rows:
        full = full * 4 + 1
        d += 1
    return d


def check_stack(n_rows: int):
    """Raise unless the walk's stack holds every entry a table of n_rows
    rows can need: a depth-first walk that pushes up to 4 children a row
    holds at most 3 * (depth - 1) + 1 entries."""
    need = 3 * (tree_depth(n_rows) - 1) + 1
    if need > STACK:
        raise ValueError(f"a beam table of {n_rows} rows is {tree_depth(n_rows)} levels deep: "
                         f"its walk needs {need} stack entries, the kernel holds {STACK}")


def _leaf_start(n_rows: int) -> int:
    """The first leaf row of beam_table's heap (rows below it are interior)."""
    return (((3 * n_rows + 1) // 4) - 1) // 3


def beam_walk(btable, rays):
    """The kernel's walk replayed as plain PyTorch (any device), all live
    lanes in lockstep: each lane walks the tree depth first with its own
    stack; a row below the leaf start pushes its children 0..3 whose padded
    box the ray meets (child 3 is visited first), a leaf row tests the 4
    records and a hit ends the lane. Any hit does not depend on the order
    of the walk, so its occlusion equals the brute-force plain version's.

    Returns (occluded (T, 1024) f32, visited (N,) bool: the rows some lane
    read, work: a dict of counts — live lanes (``live_lanes``), rows popped
    (interior and leaf; ``lane_steps`` their sum, ``max_steps`` the longest
    lane's), lane box tests and lane record tests)."""
    N = btable.shape[0]
    check_stack(N)
    I = _leaf_start(N)
    T = rays.shape[0]
    dev = rays.device
    r = rays.permute(0, 2, 1).reshape(-1, 8)
    idx = live_lanes(rays)
    o, d, tmax = r[idx, 0:3], r[idx, 3:6], r[idx, 6]
    inv = safe_inv_dir(d)
    R = idx.shape[0]
    stk = torch.zeros((R, STACK), dtype=torch.int64, device=dev)
    sp = torch.ones(R, dtype=torch.int64, device=dev)
    hit = torch.zeros(R, dtype=torch.bool, device=dev)
    steps = torch.zeros(R, dtype=torch.int64, device=dev)
    visited = torch.zeros(N, dtype=torch.bool, device=dev)
    work = dict(live=R, interior_rows=0, leaf_rows=0, box_tests=0, record_tests=0)
    while True:
        li = torch.nonzero((sp > 0) & ~hit).flatten()
        if li.numel() == 0:
            break
        spl = sp[li] - 1
        q = stk[li, spl]
        visited[q] = True
        steps[li] += 1
        leaf = q >= I
        ll, il = li[leaf], li[~leaf]
        if ll.numel():
            recs = btable[q[leaf]][:, :64].reshape(-1, 4, 16)
            real = recs[..., 9] >= 0.0
            tri = torch.where(real[..., None], recs[..., :9], 0.0)     # pad: det 0
            per = torch.stack([_mt_any(o[ll], d[ll], tmax[ll], tri[:, k:k + 1])
                               for k in range(4)], -1)
            # a lane tests its real records in order up to its first hit
            before = torch.cumsum(per.to(torch.int64), -1) - per.to(torch.int64) == 0
            work["record_tests"] += int((real & before).sum())
            work["leaf_rows"] += ll.numel()
            hit[ll] = per.any(-1)
        qi = q[~leaf]
        box = btable[qi][:, :24].reshape(-1, 4, 6)
        lo, hi = box[..., :3], box[..., 3:]
        pad = 1e-5 * torch.clamp(torch.maximum(lo.abs(), hi.abs()), min=1.0)
        t0 = (lo - pad - o[il, None]) * inv[il, None]
        t1 = (hi + pad - o[il, None]) * inv[il, None]
        tn = torch.clamp(torch.minimum(t0, t1).amax(-1), min=0.0)
        tf = torch.minimum(torch.maximum(t0, t1).amin(-1), tmax[il, None])
        child = 4 * qi[:, None] + 1 + torch.arange(4, device=dev)
        push = (lo <= hi).all(-1) & (tn <= tf) & (child < N)
        work["box_tests"] += int((child < N).sum())
        work["interior_rows"] += il.numel()
        spi = spl[~leaf]
        for ch in range(4):
            m = push[:, ch]
            stk[il[m], spi[m]] = child[m, ch]
            spi = spi + m.to(torch.int64)
        sp[li] = spl
        sp[il] = spi
    occ = torch.zeros(T * PIX, device=dev)
    occ[idx] = hit.to(torch.float32)
    work["lane_steps"] = int(steps.sum())
    work["max_steps"] = int(steps.max()) if R else 0
    return occ.reshape(T, PIX), visited, work


def beam_any_hit(btable, o, d, t_max, active, H: int, W: int):
    """(H, W) any-hit occlusion (bool) + the number of tiles whose traversal
    overflowed (always 0 for both versions here)."""
    rays = pack_rays_tiles(o, d, t_max, active, H, W)
    occ, ovf = beam_any_hit_tiles(btable, rays)
    return unpack_tiles(occ, H, W) > 0.5, torch.sum(ovf > 0.5)
