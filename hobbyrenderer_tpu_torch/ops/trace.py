"""Dispatch for incoherent rays (counterpart of hobbyrenderer_tpu/ops/
trace.py::closest_hit_auto / any_hit_auto): both go to the 16-wide BVH walk
(K3, ops/bvh16.py) on ``rt.bvh16``, as the JAX package's TPU branch does.

``max_steps`` is a 4-ary-walk budget, as in the JAX API; the 16-wide walk
drains about 4x faster per step, so it runs max(24, max_steps // 4) steps
(trace.py:498). The sorted-block beam path (K6) and the 4-ary wavefront
walk are not part of this port yet."""

from __future__ import annotations

import torch

from hobbyrenderer_tpu_torch.ops import bvh16 as b16ops

TMAX_CAP = 1e30   # finite stand-in for "no t_max"


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


def closest_hit_auto(rt, o, d, t_min: float = 1e-4, t_max=None, max_steps=None,
                     active=None) -> b16ops.HitRecord:
    t_max = _masked_t_max(t_max, active, o.shape[0], o.device)
    return b16ops.bvh16_closest_hit(rt.bvh16, o, d, t_min=t_min, t_max=t_max,
                                    max_steps=_walk_steps(max_steps))


def any_hit_auto(rt, o, d, t_max=None, active=None, max_steps=None,
                 return_capped: bool = False):
    """Occluded (R,) bool (and the capped rays, see bvh16_any_hit)."""
    t_max = _masked_t_max(t_max, active, o.shape[0], o.device)
    return b16ops.bvh16_any_hit(rt.bvh16, o, d, t_max=t_max,
                                max_steps=_walk_steps(max_steps),
                                return_capped=return_capped)
