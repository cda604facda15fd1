"""Dispatch for incoherent rays and the sorted-block trace route
(counterpart of hobbyrenderer_tpu/ops/trace.py).

``closest_hit_auto`` / ``any_hit_auto`` go to the 16-wide BVH walk (K3,
ops/bvh16.py) on ``rt.bvh16``, as the JAX package's TPU branch does.
``max_steps`` is a 4-ary-walk budget, as in the JAX API; the 16-wide walk
drains about 4x faster per step, so it runs max(24, max_steps // 4) steps
(trace.py:498).

With ``force_kernel=True`` and a beam table on ``rt`` they take the
sorted-block route instead (trace.py:442-445, 480-483): rays are sorted by a
5-D Morton key of origin and octahedral direction (``coherence_key``),
packed into 1024-ray blocks, and traced per block, closest hits by K6
(ops/trace_kernel.py), occlusion by K4 (ops/beam.py). No step budget
applies there; a block whose BFS frontier overflowed may miss hits (the
kernels' overflow flags say which). No pass asks for this route, as in the
JAX package. The 4-ary wavefront walk is not part of this port."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hobbyrenderer_tpu_torch.ops import beam as beamops
from hobbyrenderer_tpu_torch.ops import bvh16 as b16ops
from hobbyrenderer_tpu_torch.ops import trace_kernel as tk

TMAX_CAP = 1e30   # finite stand-in for "no t_max" (keeps interval math finite)
PIX = tk.PIX


def _walk_steps(max_steps):
    return None if max_steps is None else max(24, max_steps // 4)


def _masked_t_max(t_max, active, R, dev):
    """Inactive lanes get t_max 0: the root box test fails and they finish
    in one step (reported as a miss)."""
    if active is None:
        return t_max
    tm = (torch.full((R,), TMAX_CAP, dtype=torch.float32, device=dev) if t_max is None
          else torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev),
                                  (R,)))
    return torch.where(active, tm, 0.0)


# ---------------------------------------------------------------------------
# coherence sort + block packing
# ---------------------------------------------------------------------------

def coherence_key(o, d, root_box):
    """5-D Morton key over (origin xyz, octahedral direction uv), 4 bits per
    dimension, MSB-first interleaved (x y z u v | x y z u v | ...): any run
    of consecutive sorted keys is tight in origin and direction at once.
    o, d (R, 3) f32, root_box (6,) -> (R,) int64 keys below 2^20."""
    NB = 4
    lo = root_box[:3]
    inv = 1.0 / torch.clamp(root_box[3:] - lo, min=1e-6)
    q = torch.clamp(((o - lo) * inv * (1 << NB)).to(torch.int32), 0, (1 << NB) - 1)
    nrm = torch.clamp(torch.abs(d[:, 0]) + torch.abs(d[:, 1]) + torch.abs(d[:, 2]), min=1e-12)
    px, py = d[:, 0] / nrm, d[:, 1] / nrm
    fold = d[:, 2] < 0
    fx = torch.where(fold, (1 - torch.abs(py)) * torch.where(px >= 0, 1.0, -1.0), px)
    fy = torch.where(fold, (1 - torch.abs(px)) * torch.where(py >= 0, 1.0, -1.0), py)
    cu = torch.clamp(((fx * 0.5 + 0.5) * (1 << NB)).to(torch.int32), 0, (1 << NB) - 1)
    cv = torch.clamp(((fy * 0.5 + 0.5) * (1 << NB)).to(torch.int32), 0, (1 << NB) - 1)
    dims = [c.to(torch.int64) for c in (q[:, 0], q[:, 1], q[:, 2], cu, cv)]
    key = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    for j in range(NB - 1, -1, -1):              # MSB first
        for c in dims:
            key = (key << 1) | ((c >> j) & 1)
    return key


def pack_rays_sorted(o, d, t_max, active, root_box):
    """Flat rays (R, 3) / (R,) -> (blocks (T, 8, 1024), sort permutation
    (R,)): a stable sort by ``coherence_key``; blocks are consecutive runs
    of 1024 sorted rays, the last padded with inactive lanes."""
    R = o.shape[0]
    order = torch.argsort(coherence_key(o, d, root_box), stable=True)
    T = -(-R // PIX)
    comp = torch.cat([o, d, t_max.to(torch.float32)[:, None],
                      active.to(torch.float32)[:, None]], 1)[order]       # (R, 8)
    comp = F.pad(comp, (0, 0, 0, T * PIX - R))
    return comp.reshape(T, PIX, 8).permute(0, 2, 1).contiguous(), order


def unpack_sorted(vals, order, R: int):
    """(T, 1024) block results -> (R,) in the caller's order."""
    flat = vals.reshape(-1)[:R]
    return torch.zeros(R, dtype=flat.dtype, device=flat.device).index_put_((order,), flat)


def _block_t_max(t_max, R, dev):
    if t_max is None:
        return torch.full((R,), TMAX_CAP, dtype=torch.float32, device=dev)
    return torch.clamp(torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                                          device=dev), (R,)), max=TMAX_CAP)


def _root_box(root_box, dev):
    return torch.as_tensor(root_box, dtype=torch.float32, device=dev)


def trace_closest(btable, root_box, o, d, t_min: float = 1e-4, t_max=None, active=None):
    """Closest hits of rays o, d (R, 3) through sorted blocks (K6): a
    HitRecord in the caller's order, t = INF and tri = -1 on a miss."""
    R = o.shape[0]
    dev = o.device
    tm = _block_t_max(t_max, R, dev)
    if active is None:
        active = torch.ones((R,), dtype=torch.bool, device=dev)
    rays, order = pack_rays_sorted(o, d, tm, active, _root_box(root_box, dev))
    t, tri, u, v, f, _ovf = tk.closest_hit_blocks(btable, rays, t_min=t_min)
    tri_o = unpack_sorted(tri, order, R).to(torch.int32)
    miss = tri_o < 0
    return b16ops.HitRecord(t=torch.where(miss, b16ops.INF, unpack_sorted(t, order, R)),
                            tri=torch.where(miss, -1, tri_o),
                            u=unpack_sorted(u, order, R), v=unpack_sorted(v, order, R),
                            front=unpack_sorted(f, order, R) > 0.5)


def trace_any_hit(btable, root_box, o, d, t_max=None, active=None):
    """Occlusion (R,) bool of rays o, d through sorted blocks: the same
    coherence sort in front of the any-hit kernel K4."""
    R = o.shape[0]
    dev = o.device
    tm = _block_t_max(t_max, R, dev)
    if active is None:
        active = torch.ones((R,), dtype=torch.bool, device=dev)
    rays, order = pack_rays_sorted(o, d, tm, active, _root_box(root_box, dev))
    occ, _ovf = beamops.beam_any_hit_tiles(btable, rays)
    return unpack_sorted(occ, order, R) > 0.5


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def closest_hit_auto(rt, o, d, t_min: float = 1e-4, t_max=None, max_steps=None,
                     active=None, force_kernel: bool = False, return_capped: bool = False):
    """Closest hits (a HitRecord): the sorted-block route (K6) with
    ``force_kernel`` and a beam table on ``rt``, else the bvh16 walk (K3).
    With ``return_capped`` also the rays the walk's step budget may have cut
    short (none on the sorted-block route)."""
    if force_kernel and getattr(rt, "btable", None) is not None:
        rec = trace_closest(rt.btable, rt.bvh.root_box, o, d, t_min=t_min, t_max=t_max,
                            active=active)
        return (rec, torch.zeros_like(rec.front)) if return_capped else rec
    t_max = _masked_t_max(t_max, active, o.shape[0], o.device)
    return b16ops.bvh16_closest_hit(rt.bvh16, o, d, t_min=t_min, t_max=t_max,
                                    max_steps=_walk_steps(max_steps),
                                    return_capped=return_capped)


def closest_hit_counted(rt, o, d, active, max_steps=None):
    """``closest_hit_auto`` on the bvh16 walk for a pass that reports it:
    (HitRecord, {"lanes", "capped"}) as device scalars: the active lanes
    that walked K3 and those that spent its step budget."""
    hit, capped = closest_hit_auto(rt, o, d, max_steps=max_steps, active=active,
                                   return_capped=True)
    return hit, {"lanes": active.sum(), "capped": (capped & active).sum()}


def any_hit_auto(rt, o, d, t_max=None, active=None, max_steps=None,
                 return_capped: bool = False, force_kernel: bool = False):
    """Occluded (R,) bool: the sorted-block route (K4 behind the coherence
    sort) with ``force_kernel`` and a beam table on ``rt``, else the bvh16
    walk (K3). With ``return_capped`` also the rays the walk's step budget
    may have cut short (none on the sorted-block route)."""
    if force_kernel and getattr(rt, "btable", None) is not None:
        occ = trace_any_hit(rt.btable, rt.bvh.root_box, o, d, t_max=t_max, active=active)
        return (occ, torch.zeros_like(occ)) if return_capped else occ
    t_max = _masked_t_max(t_max, active, o.shape[0], o.device)
    return b16ops.bvh16_any_hit(rt.bvh16, o, d, t_max=t_max,
                                max_steps=_walk_steps(max_steps),
                                return_capped=return_capped)
