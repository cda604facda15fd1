"""SHARC: the world-space spatial-hash radiance cache (counterpart of
hobbyrenderer_tpu/ops/sharc.py).

Cells are camera-distance-scaled voxels plus the normal's octant, folded to
a 32-bit key (0 = empty slot); a key's probe window is PROBES slots from a
hashed base. ``sharc_update`` lets each sample pick a slot of its window
(key match, else an empty or stale slot, else the base), sorts the samples
by slot and merges each slot's samples into one candidate; ``sharc_resolve``
ages and evicts; ``sharc_query`` looks keys up. Keys are uint32 values held
in int64 tensors, as utils/rng.py holds its words.

No step reads a device value back to the host, and the cache is the same
bits run to run on every device: the per-slot sums and the key maximum are
segmented scans over the sorted samples (a fixed binary tree of elementwise
operations, see ``_segment_scan``), not atomic scatter-adds, whose order on
CUDA varies from run to run. The reference sums each slot's samples in
sorted order (``jax.ops.segment_sum``); the tree adds them in another order,
so the radiance differs from the reference's by rounding only."""

from __future__ import annotations

from typing import NamedTuple

import torch

from hobbyrenderer_tpu_torch.utils.rng import MASK32, pcg3d

CACHE_ENTRIES = 1 << 20       # n must be a power of two
PROBES = 4                    # linear-probe window
BASE_CELL = 0.25              # voxel size at distance ~1
STALE_FRAMES = 64.0           # eviction age
EMA = 0.05


class SharcCache(NamedTuple):
    key: torch.Tensor         # (N,) int64 holding the uint32 cell key, 0 = empty
    radiance: torch.Tensor    # (N, 3) f32 resolved radiance
    age: torch.Tensor         # (N,) f32 frames since last touch


def sharc_init(device, n: int = CACHE_ENTRIES) -> SharcCache:
    if n & (n - 1):
        raise ValueError("cache size must be a power of two")
    return SharcCache(key=torch.zeros(n, dtype=torch.int64, device=device),
                      radiance=torch.zeros((n, 3), device=device),
                      age=torch.full((n,), 1e9, device=device))


def _cell_key(pos, normal, cam_pos):
    """Quantized position (log-distance-scaled voxels) + normal octant ->
    uint32 key in int64; never 0 (the empty sentinel)."""
    rel = pos - cam_pos
    d = torch.sqrt(torch.sum(rel * rel, -1, keepdim=True))
    level = torch.clamp(torch.floor(torch.log2(torch.clamp(d / 4.0, min=1e-3))), 0.0, 6.0)
    cell = BASE_CELL * torch.exp2(level)
    # negative voxel coordinates wrap mod 2^32, as the reference's
    # astype(uint32) of an int32 does
    q = torch.floor(pos / cell).to(torch.int64) & MASK32
    oct_n = ((normal[..., 0] > 0).to(torch.int64)
             | ((normal[..., 1] > 0).to(torch.int64) << 1)
             | ((normal[..., 2] > 0).to(torch.int64) << 2))
    v = torch.stack([q[..., 0], q[..., 1],
                     q[..., 2] ^ (oct_n << 27) ^ (level[..., 0].to(torch.int64) << 24)], -1)
    h = pcg3d(v)
    key = h[..., 0] ^ ((h[..., 1] << 1) & MASK32)
    return torch.clamp(key, min=1)


def _slot_of(key, n: int):
    """Base probe slot of a key (its window is base..base+PROBES-1 mod n)."""
    h = pcg3d(torch.stack([key, key ^ 0x9E3779B9, torch.full_like(key, 17)], -1))[..., 2]
    return h % n


def _probe_slots(key, n: int):
    """(..., PROBES) candidate slots, wrapping in the power-of-two table."""
    base = _slot_of(key, n)
    return (base[..., None] + torch.arange(PROBES, device=key.device)) & (n - 1)


def _signed32(key):
    """The int32 reading of uint32 keys (the reference's bitcast)."""
    return torch.where(key >= 1 << 31, key - (1 << 32), key)


def _segment_scan(x, seg, op):
    """Inclusive scan of x (R, ...) by ``op`` within runs of equal ``seg``
    (R,), which must be sorted: each run's last lane holds the reduction of
    the run. Hillis-Steele doubling: the step of stride s combines lane i
    with lane i - s when both are in one run, so after it lane i holds the
    run's lanes in (i - 2s, i]. Every step is elementwise, so the order of
    the operations is fixed by the shape alone: the same bits on every run
    and on every device."""
    R = x.shape[0]
    s = 1
    while s < R:
        same = (seg[s:] == seg[:-s]).reshape((-1,) + (1,) * (x.ndim - 1))
        x = torch.cat([x[:s], torch.where(same, op(x[s:], x[:-s]), x[s:])])
        s *= 2
    return x


def _per_slot(x_scan, slot_s, n: int, fill):
    """(n,) + x.shape[1:] table of each run's reduction (a run's last lane)
    at its slot; slots no sample reached hold ``fill``. Lanes that do not
    end a run write a spare row n + 1, so each real row has one writer."""
    R = slot_s.shape[0]
    last = torch.ones(R, dtype=torch.bool, device=slot_s.device)
    last[:-1] = slot_s[1:] != slot_s[:-1]
    idx = torch.where(last, slot_s, n + 1)
    out = torch.full((n + 2,) + x_scan.shape[1:], fill, dtype=x_scan.dtype,
                     device=x_scan.device)
    idx = idx.reshape((-1,) + (1,) * (x_scan.ndim - 1)).expand_as(x_scan)
    return out.scatter_(0, idx, x_scan)[:n]


def sharc_update(cache: SharcCache, sample_pos, sample_normal, sample_radiance,
                 sample_valid, cam_pos) -> SharcCache:
    """Insert or blend secondary-bounce samples: each sample picks a slot of
    its probe window first-fit (key match > empty or stale > base), the
    samples sort by slot (stable), and each slot's mean EMA-blends into a
    matching entry, claims an empty or stale one, or leaves a live entry of
    another key alone. Of several keys in one slot, the largest as a signed
    int32 is the slot's candidate (the reference's segment_max over keys
    bitcast to int32)."""
    n = cache.key.shape[0]
    dev = cache.key.device
    key = _cell_key(sample_pos, sample_normal, cam_pos)
    cand = _probe_slots(key, n)                       # (R, PROBES)
    ck = cache.key[cand]
    cage = cache.age[cand]
    is_match = ck == key[..., None]
    is_free = (ck == 0) | (cage > STALE_FRAMES)
    # first-fit priority: match (2) > free (1) > none (0); earlier probe wins
    prio = is_match.to(torch.int64) * 2 + is_free.to(torch.int64)
    rank = prio * PROBES + (PROBES - 1 - torch.arange(PROBES, device=dev))
    slot = torch.gather(cand, -1, torch.argmax(rank, -1, keepdim=True))[..., 0]

    slot = torch.where(sample_valid, slot, n)         # n = dropped
    slot_s, order = torch.sort(slot, stable=True)
    key_s = key[order]
    rad_s = sample_radiance[order]

    # per-slot count and radiance sum in one scan; key maximum over int32
    cnt_rad = _segment_scan(torch.cat([torch.ones_like(rad_s[:, :1]), rad_s], 1), slot_s,
                            torch.add)
    sums = _per_slot(cnt_rad, slot_s, n, 0.0)
    seg, rad_sum = sums[:, 0], sums[:, 1:]
    key_max = _segment_scan(_signed32(key_s), slot_s, torch.maximum)
    key_any = _per_slot(key_max, slot_s, n, 0) & MASK32
    touched = seg > 0
    mean_rad = rad_sum / torch.clamp(seg, min=1.0)[..., None]

    stale = cache.age > STALE_FRAMES
    empty = cache.key == 0
    match = (cache.key == key_any) & touched
    claim = touched & (empty | stale) & ~match

    blend = torch.clamp(EMA * torch.sqrt(seg)[..., None], max=1.0)
    new_rad = torch.where(match[..., None],
                          cache.radiance + (mean_rad - cache.radiance) * blend, cache.radiance)
    new_rad = torch.where(claim[..., None], mean_rad, new_rad)
    new_key = torch.where(claim, key_any, cache.key)
    new_age = torch.where(match | claim, 0.0, cache.age)
    return SharcCache(key=new_key, radiance=new_rad, age=new_age)


def sharc_resolve(cache: SharcCache) -> SharcCache:
    """Per-frame aging and eviction."""
    age = cache.age + 1.0
    dead = age > 4.0 * STALE_FRAMES
    return SharcCache(key=torch.where(dead, 0, cache.key),
                      radiance=torch.where(dead[..., None], 0.0, cache.radiance), age=age)


def sharc_query(cache: SharcCache, pos, normal, cam_pos):
    """Lookup: PROBES gathers, the first live key match wins. Returns
    (radiance, hit)."""
    n = cache.key.shape[0]
    key = _cell_key(pos, normal, cam_pos)
    cand = _probe_slots(key, n)
    live = cache.age[cand] < 2.0 * STALE_FRAMES
    m = (cache.key[cand] == key[..., None]) & live      # (..., PROBES)
    # the first true probe: the largest of m * (PROBES - probe)
    first = torch.argmax(m.to(torch.int64) * (PROBES - torch.arange(PROBES, device=key.device)),
                         -1, keepdim=True)
    slot = torch.gather(cand, -1, first)[..., 0]
    hit = m.any(-1)
    return torch.where(hit[..., None], cache.radiance[slot], 0.0), hit
