"""The 4-wide implicit-heap BVH of hobbyrenderer_tpu/ops/bvh.py: the host
build (build_bvh: the same level-wise median split, the same unified
(I+L, 40) node table, bit-identical output) and the per-frame refit on the
device (refit_bvh). The leaf rows and box levels are torch functions that
both use (on CPU tensors at build)."""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

LEAF_SIZE = 4


class BVH(NamedTuple):
    """numpy arrays from build_bvh, tensors after bvh_to_device / refit."""
    table: np.ndarray     # (I + L, 40) f32 unified node rows
    order: np.ndarray     # (L * K,) leaf slot -> triangle id (-1 pad)
    root_box: np.ndarray  # (6,) f32 scene bounds (lo, hi)
    num_tris: int


def _median_split_order(cent: np.ndarray, L: int, leaf_size: int) -> np.ndarray:
    """Level-wise widest-axis median split -> permutation of N=L*K slots."""
    N = L * leaf_size
    order = np.arange(N)
    n_levels = int(np.log2(L)) if L > 1 else 0
    for lvl in range(n_levels):
        seg_size = N >> lvl
        starts = np.arange(0, N, seg_size)
        c = cent[order]
        cf = np.where(np.isfinite(c), c, np.nan)
        seg_lo = np.full((len(starts), 3), np.inf, np.float32)
        seg_hi = np.full((len(starts), 3), -np.inf, np.float32)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for ax in range(3):
                col = cf[:, ax].reshape(len(starts), seg_size)
                seg_lo[:, ax] = np.nanmin(col, axis=1)
                seg_hi[:, ax] = np.nanmax(col, axis=1)
        seg_lo = np.where(np.isfinite(seg_lo), seg_lo, 0.0)
        seg_hi = np.where(np.isfinite(seg_hi), seg_hi, 0.0)
        axis = np.argmax(seg_hi - seg_lo, axis=1)
        seg_of = np.arange(N) // seg_size
        key = c[np.arange(N), axis[seg_of]]
        key = np.where(np.isfinite(key), key, np.inf)
        perm = np.lexsort((key, seg_of))
        order = order[perm]
    return order


def _binary_level_boxes(vlo, vhi):
    """Leaf boxes (L, 3) -> [(lo, hi)] per binary level, bottom-up."""
    levels = [(vlo, vhi)]
    lo, hi = vlo, vhi
    while lo.shape[0] > 1:
        lo = torch.minimum(lo[0::2], lo[1::2])
        hi = torch.maximum(hi[0::2], hi[1::2])
        levels.append((lo, hi))
    return levels


def _assemble_table(leaf_rows, levels, L: int):
    """Interior rows (4 child boxes each) from binary levels + leaf rows."""
    W = leaf_rows.shape[1]
    n_bin = int(np.log2(L)) if L > 1 else 0
    rows = []
    for k in range(n_bin // 2):
        lo, hi = levels[n_bin - 2 * (k + 1)]
        rows.append(torch.cat([lo, hi], 1).reshape(-1, 24))
    if rows:
        interior = torch.cat(rows, 0)
        pad = interior.new_zeros((interior.shape[0], W - 24))
        return torch.cat([torch.cat([interior, pad], 1), leaf_rows], 0)
    return leaf_rows


def _leaf_data(sorted_tris, tri_id, L: int, leaf_size: int):
    """Sorted triangles (L*K, 3, 3) and their ids (-1 = padding) ->
    (leaf_rows (L, 10K) [v0 e1 e2 tid] per slot, leaf lo / hi (L, 3));
    a leaf without a triangle gets an inverted box (never hit)."""
    v0 = sorted_tris[:, 0]
    e1 = sorted_tris[:, 1] - v0
    e2 = sorted_tris[:, 2] - v0
    tid = tri_id.to(sorted_tris.dtype)[:, None]
    leaf_rows = torch.cat([v0, e1, e2, tid], 1).reshape(L, leaf_size * 10)
    leaf_tris = sorted_tris.reshape(L, leaf_size, 3, 3)
    valid = tri_id.reshape(L, leaf_size) >= 0
    vlo = torch.where(valid[..., None, None], leaf_tris, 1e30).reshape(L, -1, 3).amin(1)
    vhi = torch.where(valid[..., None, None], leaf_tris, -1e30).reshape(L, -1, 3).amax(1)
    empty = ~valid.any(1)[:, None]
    return leaf_rows, torch.where(empty, 1e30, vlo), torch.where(empty, -1e30, vhi)


def _sorted_leaves(tri_verts, order, T: int):
    """The median split's slot order -> (sorted triangles (N, 3, 3) f32,
    1e30 in padding slots, and slot -> triangle id, -1 = padding), as CPU
    tensors."""
    valid = order < T
    sorted_tris = np.where(valid[:, None, None], tri_verts[np.minimum(order, T - 1)],
                           np.float32(1e30))
    tri_id = np.where(valid, order, -1).astype(np.int32)
    return torch.from_numpy(sorted_tris), torch.from_numpy(tri_id)


def build_bvh(tri_verts: np.ndarray) -> BVH:
    """tri_verts (T, 3, 3) f32 -> BVH (numpy). T < 2^24 (ids ride f32)."""
    assert tri_verts.shape[0] < (1 << 24), \
        "triangle ids are carried as f32; >= 2^24 tris are not representable"
    leaf_size = LEAF_SIZE
    tri_verts = np.asarray(tri_verts, np.float32)
    T = tri_verts.shape[0]
    assert T > 0, "empty BVH"
    L = 1
    while L * leaf_size < T:
        L *= 4
    N = L * leaf_size
    pad = N - T
    cent = tri_verts.mean(axis=1)
    if pad:
        cent = np.concatenate([cent, np.full((pad, 3), np.inf, np.float32)], 0)
    order = _median_split_order(cent, L, leaf_size)
    sorted_tris, tri_id = _sorted_leaves(tri_verts, order, T)
    leaf_rows, vlo, vhi = _leaf_data(sorted_tris, tri_id, L, leaf_size)
    levels = _binary_level_boxes(vlo, vhi)
    table = _assemble_table(leaf_rows, levels, L)
    root_lo, root_hi = levels[-1]
    return BVH(table=table.numpy(), order=tri_id.numpy(),
               root_box=torch.cat([root_lo[0], root_hi[0]]).numpy(), num_tris=T)


def bvh_to_device(bvh: BVH, device) -> BVH:
    """The tree's arrays as tensors on ``device`` (order as int64)."""
    def t(a, dtype):
        return torch.as_tensor(a, device=device).to(dtype)
    return BVH(table=t(bvh.table, torch.float32), order=t(bvh.order, torch.int64),
               root_box=t(bvh.root_box, torch.float32), num_tris=bvh.num_tris)


def refit_leaves(order, L: int, K: int, tri_verts):
    """The leaf rows, binary box levels and root box of a tree whose slots
    hold the triangles ``order`` (L*K,) names (-1 = padding), over
    tri_verts (T, 3, 3): the triangles it was built over at their new
    positions. Shared by refit_bvh and bvh16.refit_bvh16."""
    st = torch.where((order >= 0)[:, None, None], tri_verts[torch.clamp(order, min=0)], 1e30)
    leaf_rows, vlo, vhi = _leaf_data(st, order, L, K)
    levels = _binary_level_boxes(vlo, vhi)
    root_lo, root_hi = levels[-1]
    return leaf_rows, levels, torch.cat([root_lo[0], root_hi[0]])


def refit_bvh(bvh: BVH, tri_verts) -> BVH:
    """The same tree over moved triangles: tri_verts (T, 3, 3), the
    triangles the tree was built over at their new positions, on the
    tree's device. Leaf rows and every box level are recomputed with
    min / max sweeps (the per-frame refit of an animated scene)."""
    L = (3 * bvh.table.shape[0] + 1) // 4
    leaf_rows, levels, root_box = refit_leaves(bvh.order, L, bvh.order.shape[0] // L,
                                               tri_verts)
    return bvh._replace(table=_assemble_table(leaf_rows, levels, L), root_box=root_box)
