"""16-wide BVH: host build, the walk kernel's wrapper and its plain PyTorch
version (counterpart of hobbyrenderer_tpu/ops/bvh16.py build_bvh16 /
_traverse16 and of the Pallas walk ops/wtrace.py::_wtrace_kernel, K3).

Layout: a 16-ary implicit heap (children of q are 16q+1..16q+16), I =
(16^m - 1)/15 interior rows then L = 16^m leaf rows, each ONE contiguous
128-f32 row (512 B), kept ROW-MAJOR: (I+L, 128). The JAX table is stored
transposed (128, I+L); ``from_jax_table`` converts. Interior rows hold the
16 child boxes (lo3|hi3, lanes 0:96); leaf rows hold 12 triangle records
[v0 e1 e2 tid] (lanes 0:120, tid -1 = padding).

The walk follows ``_step16``'s rules exactly, so its node visits and step
count equal the JAX walk's (mxu=False) ray for ray, capped or not: one row
per step, fp32 slab tests, nearest-first descent (any hit: lowest child),
a per-level 16-bit trail of pending children popped deepest-first by
count-trailing-zeros, best_t tightening, Möller-Trumbore over the leaf's
records, any-hit exit on the first hit, and an iteration cap ``max_steps``.

``bvh16_walk`` launches csrc/bvh16_walk.cu for CUDA tensors and runs
``bvh16_walk_reference`` (a lockstep wavefront over the live rays, one phase)
for CPU tensors; nothing else chooses. The kernel walks a ray with a
half-warp, in as many CTAs as the card keeps resident (``launch_grid``),
which take rays from a queue the kernel leaves at zero. The JAX
walk's phased compaction (PHASES16) and its bf16 one-hot MXU interior fetch
are TPU scaffolding and are not ported."""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from hobbyrenderer_tpu_torch import kernels
from hobbyrenderer_tpu_torch.ops.bvh import (_binary_level_boxes, _leaf_data,
                                             _median_split_order)
from hobbyrenderer_tpu_torch.ops.intersect import safe_inv_dir

LEAF16 = 12          # triangle records per leaf row
ROW_W = 128
# the JAX walk's step budget when no cap is given: sum of its PHASES16 steps
UNCAPPED_STEPS = 12 + 12 + 24 + 384
INF = 3.0e38

launches = 0      # kernel launches (CPU reference calls are not counted)
RAYS_A_CTA = 16   # K3's CTA: 256 threads, a half-warp a ray


class BVH16(NamedTuple):
    table: torch.Tensor     # (I + L, 128) f32 node rows, row-major
    order: torch.Tensor     # (L * K,) leaf slot -> triangle id (-1 pad)
    root_box: torch.Tensor  # (6,) f32 scene bounds (lo, hi)
    recs: torch.Tensor      # (L * K, 9) f32 v0|e1|e2 per leaf slot
    slot_of: torch.Tensor   # (T,) original tri id -> leaf slot
    num_tris: int

    @property
    def num_leaves(self) -> int:
        return (15 * self.table.shape[0] + 1) // 16

    @property
    def n_interior(self) -> int:
        return (self.num_leaves - 1) // 15

    @property
    def depth(self) -> int:
        """16-ary levels below the root (= the leaf level index m)."""
        m = 0
        while 16 ** m < self.num_leaves:
            m += 1
        return m


class HitRecord(NamedTuple):
    t: torch.Tensor       # (R,) f32 hit distance (INF = miss)
    tri: torch.Tensor     # (R,) triangle id (-1 = miss)
    u: torch.Tensor
    v: torch.Tensor
    front: torch.Tensor   # (R,) bool


def _assemble16(leaf_rows, levels, L: int) -> np.ndarray:
    """Binary level boxes + leaf rows -> row-major (I + L, 128) table."""
    n_bin = int(np.log2(L)) if L > 1 else 0
    leaf_rows = np.concatenate(
        [leaf_rows, np.zeros((leaf_rows.shape[0], ROW_W - leaf_rows.shape[1]),
                             leaf_rows.dtype)], axis=1)
    rows = []
    for k in range(n_bin // 4):
        lo, hi = levels[n_bin - 4 * (k + 1)]           # (16^(k+1), 3)
        r = np.concatenate([lo, hi], axis=1).reshape(16 ** k, 96)
        rows.append(np.concatenate([r, np.zeros((r.shape[0], ROW_W - 96), r.dtype)], 1))
    return np.concatenate(rows + [leaf_rows], axis=0)


def build_bvh16_arrays(tri_verts: np.ndarray, leaf_size: int = LEAF16) -> dict:
    """tri_verts (T, 3, 3) f32 -> numpy arrays {table (row-major), order,
    root_box, recs, slot_of}; the same median split as the 4-wide build."""
    assert tri_verts.shape[0] < (1 << 24), \
        "triangle ids are carried as f32; >= 2^24 tris are not representable"
    tri_verts = np.asarray(tri_verts, np.float32)
    T = tri_verts.shape[0]
    assert T > 0, "empty BVH"
    L = 1
    while L * leaf_size < T:
        L *= 16
    N = L * leaf_size
    cent = tri_verts.mean(axis=1)
    if N > T:
        cent = np.concatenate([cent, np.full((N - T, 3), np.inf, np.float32)], 0)
    order = _median_split_order(cent, L, leaf_size)
    valid = order < T
    sorted_tris = np.where(valid[:, None, None], tri_verts[np.minimum(order, T - 1)],
                           np.float32(1e30))
    tri_id = np.where(valid, order, -1).astype(np.int32)
    leaf_rows, vlo, vhi = _leaf_data(sorted_tris, tri_id, L, leaf_size)
    empty = ~(tri_id.reshape(L, leaf_size) >= 0).any(1)
    vlo[empty] = np.float32(1e30)       # inverted box: never descended
    vhi[empty] = np.float32(-1e30)
    levels = _binary_level_boxes(vlo, vhi)
    table = np.ascontiguousarray(_assemble16(leaf_rows, levels, L), np.float32)
    root_lo, root_hi = levels[-1]
    slot_of = np.zeros(T, np.int32)
    slot_of[tri_id[valid]] = np.arange(N, dtype=np.int32)[valid]
    return dict(table=table, order=tri_id,
                root_box=np.concatenate([root_lo[0], root_hi[0]]).astype(np.float32),
                recs=leaf_rows.reshape(N, 10)[:, :9].copy(), slot_of=slot_of)


def bvh16_from_numpy(d: dict, num_tris: int, device) -> BVH16:
    def t(a):
        a = np.asarray(a)
        if a.dtype.kind in "iu":
            return torch.as_tensor(a.astype(np.int64), device=device)
        return torch.as_tensor(np.array(a, dtype=np.float32), device=device)
    return BVH16(num_tris=num_tris, **{k: t(d[k]) for k in
                                       ("table", "order", "root_box", "recs", "slot_of")})


def build_bvh16(tri_verts: np.ndarray, device) -> BVH16:
    return bvh16_from_numpy(build_bvh16_arrays(tri_verts), tri_verts.shape[0], device)


def from_jax_table(table_t: np.ndarray) -> np.ndarray:
    """The JAX package's transposed (128, I+L) table -> row-major."""
    return np.ascontiguousarray(np.asarray(table_t, np.float32).T)


# ---------------------------------------------------------------------------
# the walk: dispatch, kernel launch, plain version
# ---------------------------------------------------------------------------

def bvh16_walk(table, o, d, t_max, any_hit: bool, max_steps: int = UNCAPPED_STEPS,
               t_min: float = 1e-4):
    """Walk rays o, d (R, 3) f32 with per-ray t_max (R,) f32 through the
    row-major table -> (best_t (R,) f32, best_tri (R,) int32, steps (R,)
    int32). best_t starts at t_max; capped rays report what they found."""
    if o.device.type == "cpu":
        return bvh16_walk_reference(table, o, d, t_max, any_hit, max_steps, t_min)
    return _bvh16_walk_cuda(table, o, d, t_max, any_hit, max_steps, t_min)


def _dims(table):
    n = table.shape[0]
    L = (15 * n + 1) // 16
    m = 0
    while 16 ** m < L:
        m += 1
    return (L - 1) // 15, max(m, 1)


def launch_grid(R: int, resident_ctas: int) -> int:
    """Persistent CTAs: as many as the card keeps resident, fewer when R
    rays give fewer than a half-warp each."""
    return max(1, min(resident_ctas, -(-R // RAYS_A_CTA)))


_resident = {}    # device index -> K3's resident CTAs on the card
_queues = {}      # (device index, stream) -> K3's ray queue, left at zero


def _resident_ctas(lib, device) -> int:
    if device.index not in _resident:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            kernels.check(lib.hr_bvh16_walk_ctas_per_sm(ctypes.addressof(out)),
                          "hr_bvh16_walk_ctas_per_sm")
        if out.value < 1:
            raise RuntimeError("K3 does not fit an SM")
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        _resident[device.index] = n_sm * out.value
    return _resident[device.index]


def _queue(device, stream) -> torch.Tensor:
    """The ray queue of walks on this stream: zeroed once; each launch
    leaves it at zero, and launches on one stream run one after another."""
    key = (device.index, stream)
    if key not in _queues:
        _queues[key] = torch.zeros((2,), dtype=torch.int32, device=device)
    return _queues[key]


def _bvh16_walk_cuda(table, o, d, t_max, any_hit, max_steps, t_min):
    global launches
    R = o.shape[0]
    kernels.require(table, "table", torch.float32, (table.shape[0], ROW_W))
    kernels.require(o, "o", torch.float32, (R, 3))
    kernels.require(d, "d", torch.float32, (R, 3))
    kernels.require(t_max, "t_max", torch.float32, (R,))
    if not (table.device == o.device == d.device == t_max.device):
        raise ValueError("table and rays must be on the same device")
    if not t_min >= 0.0:
        raise ValueError(f"K3 takes t_min >= 0, got {t_min}")
    I, M = _dims(table)
    if M > 6:
        raise ValueError(f"bvh16 depth {M} above the kernel's trail of 6 levels")
    lib = kernels.library()
    stream = kernels.stream_handle(o.device)
    best_t = torch.empty((R,), dtype=torch.float32, device=o.device)
    best_tri = torch.empty((R,), dtype=torch.int32, device=o.device)
    steps = torch.empty((R,), dtype=torch.int32, device=o.device)
    err = lib.hr_bvh16_walk(table.data_ptr(), o.data_ptr(), d.data_ptr(),
                            t_max.data_ptr(), best_t.data_ptr(), best_tri.data_ptr(),
                            steps.data_ptr(), _queue(o.device, stream).data_ptr(), R, I, M,
                            int(bool(any_hit)), int(max_steps), float(t_min),
                            launch_grid(R, _resident_ctas(lib, o.device)), stream)
    kernels.check(err, "hr_bvh16_walk")
    launches += 1
    return best_t, best_tri, steps


def _ctz(x):
    """count-trailing-zeros of x's lowest set bit (x > 0 where used)."""
    lsb = x & -x
    return torch.clamp(torch.log2(lsb.clamp(min=1).to(torch.float64)).round(), min=0).to(x.dtype)


def bvh16_walk_reference(table, o, d, t_max, any_hit: bool,
                         max_steps: int = UNCAPPED_STEPS, t_min: float = 1e-4,
                         return_visited: bool = False):
    """Plain PyTorch version: the lockstep wavefront of the JAX
    ``_traverse16`` (one phase), each step over the rays still walking
    (finished rays drop out of the wavefront; each ray's arithmetic is the
    same), with each product and sum rounded as a separate op. With
    ``return_visited`` it also returns the (I+L,) bool rows some ray read:
    the kernel reads the same rows (the byte term of its bound)."""
    R = o.shape[0]
    dev = o.device
    I, M = _dims(table)
    K = LEAF16
    inv_all = safe_inv_dir(d)
    cur_all = torch.zeros(R, dtype=torch.int64, device=dev)
    mask_all = torch.zeros((R, M), dtype=torch.int64, device=dev)
    live_all = torch.ones(R, dtype=torch.bool, device=dev)
    best_t_all = t_max.clone()
    best_tri_all = torch.full((R,), -1, dtype=torch.int64, device=dev)
    steps = torch.zeros(R, dtype=torch.int32, device=dev)
    ki = torch.arange(M, device=dev)[None, :]
    chw = (1 << torch.arange(16, device=dev))[:, None]
    ths = [(16 ** (k + 1) - 1) // 15 for k in range(M)]   # first id of level k+1
    visited = torch.zeros(table.shape[0], dtype=torch.bool, device=dev)
    for _ in range(max_steps):
        idx = torch.nonzero(live_all)[:, 0]
        n = idx.shape[0]
        if n == 0:
            break
        cur, mask = cur_all[idx], mask_all[idx]
        best_t, best_tri = best_t_all[idx], best_tri_all[idx]
        ox, oy, oz = o[idx, 0], o[idx, 1], o[idx, 2]
        dx, dy, dz = d[idx, 0], d[idx, 1], d[idx, 2]
        ix, iy, iz = inv_all[idx, 0], inv_all[idx, 1], inv_all[idx, 2]
        lvl = sum((cur >= th).to(torch.int64) for th in ths)
        do = cur >= 0
        steps[idx] += do.to(torch.int32)
        if return_visited:
            visited[cur[do]] = True
        cols = table[torch.clamp(cur, min=0)].T                    # (128, n)
        is_leaf = cur >= I

        # leaf: K triangle tests, (K, n)
        rec = cols[:10 * K].reshape(K, 10, n)
        v0x, v0y, v0z = rec[:, 0], rec[:, 1], rec[:, 2]
        e1x, e1y, e1z = rec[:, 3], rec[:, 4], rec[:, 5]
        e2x, e2y, e2z = rec[:, 6], rec[:, 7], rec[:, 8]
        tid = rec[:, 9]
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det, 0.0)
        sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
        uu = (sx * px + sy * py + sz * pz) * inv_det
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        vv = (dx * qx + dy * qy + dz * qz) * inv_det
        tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        thit = ((torch.abs(det) > 1e-12) & (uu >= -1e-7) & (vv >= -1e-7)
                & (uu + vv <= 1.0 + 1e-7) & (tt > t_min) & (tt < best_t)
                & (tid >= 0.0) & (do & is_leaf))
        tcand = torch.where(thit, tt, INF)
        kbest = torch.argmin(tcand, dim=0)
        tmin_leaf = torch.gather(tcand, 0, kbest[None])[0]
        lhit = tmin_leaf < best_t
        best_tri = torch.where(lhit, torch.gather(tid, 0, kbest[None])[0].to(torch.int64),
                               best_tri)
        best_t = torch.where(lhit, tmin_leaf, best_t)

        # interior: 16 slab tests, (16, n)
        box = cols[:96].reshape(16, 6, n)
        lox, loy, loz = box[:, 0], box[:, 1], box[:, 2]
        hix, hiy, hiz = box[:, 3], box[:, 4], box[:, 5]
        t0x, t1x = (lox - ox) * ix, (hix - ox) * ix
        t0y, t1y = (loy - oy) * iy, (hiy - oy) * iy
        t0z, t1z = (loz - oz) * iz, (hiz - oz) * iz
        t_en = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                             torch.minimum(t0z, t1z))
        t_ex = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                             torch.maximum(t0z, t1z))
        bhit = ((t_en <= t_ex * 1.00000024) & (t_ex > 0.0) & (t_en < best_t)
                & (lox <= hix) & (do & ~is_leaf))
        bits = torch.sum(torch.where(bhit, chw, 0), dim=0)
        if any_hit:
            near = _ctz(bits)
            has_int = bits != 0
        else:
            tcand_b = torch.where(bhit, torch.clamp(t_en, min=0.0), INF)
            near = torch.argmin(tcand_b, dim=0)
            has_int = torch.gather(tcand_b, 0, near[None])[0] < INF
        bits = bits & ~torch.where(has_int, 1 << near, 0)
        descend = (do & ~is_leaf) & has_int
        mask = torch.where((ki == lvl[:, None]) & descend[:, None], bits[:, None], mask)

        # pop: deepest level with pending children
        need_pop = do & (is_leaf | ~has_int)
        kstar = torch.amax(torch.where(mask != 0, ki, -1), dim=1)
        has_pend = kstar >= 0
        sel = ki == kstar[:, None]
        m_k = torch.sum(torch.where(sel, mask, 0), dim=1)
        a_k = cur
        steps_up = lvl - kstar
        for _ in range(M):
            a_k = torch.where(steps_up > 0, (a_k - 1) >> 4, a_k)
            steps_up = steps_up - 1
        lsb = m_k & -m_k
        cbit = _ctz(m_k)
        mask = torch.where(sel & need_pop[:, None], mask & ~lsb[:, None], mask)
        pop = need_pop & has_pend
        cur = torch.where(descend, 16 * cur + 1 + near,
                          torch.where(pop, 16 * a_k + 1 + cbit,
                                      torch.where(need_pop, -1, cur)))
        live = ~(need_pop & ~has_pend)
        if any_hit:
            live = live & ~(best_tri >= 0)
        cur_all[idx], mask_all[idx], live_all[idx] = cur, mask, live
        best_t_all[idx], best_tri_all[idx] = best_t, best_tri
    if return_visited:
        return best_t_all, best_tri_all.to(torch.int32), steps, visited
    return best_t_all, best_tri_all.to(torch.int32), steps


# ---------------------------------------------------------------------------
# closest / any hit on a BVH16
# ---------------------------------------------------------------------------

def _t_max(t_max, R, dev):
    if t_max is None:
        return torch.full((R,), INF, dtype=torch.float32, device=dev)
    return torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev),
                              (R,)).contiguous()


def bvh16_closest_hit(bvh: BVH16, o, d, t_min=1e-4, t_max=None,
                      max_steps: int = None, return_capped: bool = False):
    """Closest hit; u/v/front recomputed once from the winning record. With
    ``return_capped`` also the rays that spent the whole step budget (those
    the cap may have cut short: an upper bound on the capped rays)."""
    R = o.shape[0]
    tm = _t_max(t_max, R, o.device)
    steps_cap = UNCAPPED_STEPS if max_steps is None else max_steps
    best_t, best_tri, steps = bvh16_walk(bvh.table, o.contiguous(), d.contiguous(), tm,
                                         any_hit=False, max_steps=steps_cap, t_min=t_min)
    miss = best_tri < 0
    rec = bvh.recs[bvh.slot_of[torch.clamp(best_tri, min=0).to(torch.int64)]]
    v0, e1, e2 = rec[:, 0:3], rec[:, 3:6], rec[:, 6:9]
    p = torch.linalg.cross(d, e2, dim=-1)
    det = torch.sum(e1 * p, -1)
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det, 0.0)
    s = o - v0
    q = torch.linalg.cross(s, e1, dim=-1)
    bu = torch.sum(s * p, -1) * inv_det
    bv = torch.sum(d * q, -1) * inv_det
    rec = HitRecord(t=torch.where(miss, INF, best_t), tri=best_tri,
                    u=torch.where(miss, 0.0, bu), v=torch.where(miss, 0.0, bv),
                    front=~miss & (det > 0))
    return (rec, steps >= steps_cap) if return_capped else rec


def bvh16_any_hit(bvh: BVH16, o, d, t_min=1e-4, t_max=None, max_steps: int = None,
                  return_capped: bool = False):
    """Shadow rays: occluded (R,) bool; with ``return_capped`` also the rays
    that spent the whole step budget without a hit (those the cap may have
    cut short: an upper bound on the capped rays)."""
    R = o.shape[0]
    tm = _t_max(t_max, R, o.device)
    steps_cap = UNCAPPED_STEPS if max_steps is None else max_steps
    best_t, best_tri, steps = bvh16_walk(bvh.table, o.contiguous(), d.contiguous(), tm,
                                         any_hit=True, max_steps=steps_cap, t_min=t_min)
    occ = (best_tri >= 0) & (best_t < tm)
    if return_capped:
        return occ, (steps >= steps_cap) & (best_tri < 0)
    return occ
