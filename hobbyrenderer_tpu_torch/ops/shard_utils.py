"""Row-band sharding helpers for the screen-space passes (counterpart of
hobbyrenderer_tpu/ops/shard_utils.py).

The multi-GPU frame (parallel/) gives each rank a horizontal band of the
framebuffer. A pass whose taps reach outside the band (ReSTIR spatial
reuse, A-trous, TAA reprojection, the upsample's next row) works on a
(halo + h + halo) extended domain whose halo rows come from the
neighbouring ranks: ``extend_rows`` is one all-gather of every rank's top
and bottom boundary strips (an all-gather works under NCCL and gloo alike;
gloo has no send / recv of CUDA tensors). Taps farther than the halo clamp
to the exchanged rows. Past the frame's top and bottom the halo rows are
zeros (the JAX package's ppermute zero fill), which a caller that clamps
global rows to the frame (``ext_row_index``) never reads.

``shard=None`` (one device) makes every helper the full-frame path:
``extend_rows`` is then plain edge padding."""

from __future__ import annotations

from typing import NamedTuple

import torch


class RowShard(NamedTuple):
    """This rank's row band. ``y0`` is a host int (rank * shard_h)."""

    mesh: object   # parallel.mesh.Mesh: the ranks and their collectives
    n: int         # ranks
    y0: int        # first global row of this band
    shard_h: int   # rows a band
    full_h: int    # rows of the whole framebuffer


def make_row_shard(mesh, shard_h: int) -> RowShard:
    """This rank's band of ``shard_h`` rows."""
    return RowShard(mesh=mesh, n=mesh.n, y0=mesh.rank * shard_h, shard_h=shard_h,
                    full_h=mesh.n * shard_h)


def _edge_pad_rows(x, pad: int):
    return torch.cat([x[:1].expand(pad, *x.shape[1:]), x,
                      x[-1:].expand(pad, *x.shape[1:])], 0)


def extend_rows(x, halo: int, shard: RowShard | None = None):
    """(h, w, ...) -> (h + 2*halo, w, ...) with the neighbour bands' boundary
    rows. Without a shard (or on one rank) the rows are edge-replicated.
    Under a shard a neighbour gives at most ``take = min(halo, h)`` rows;
    past the frame's top and bottom they are zeros, as ppermute leaves
    them; and when take < halo the extended array is edge-padded to the
    full halo."""
    if halo == 0:
        return x
    if shard is None or shard.n == 1:
        return _edge_pad_rows(x, halo)
    take = min(halo, x.shape[0])
    strips = shard.mesh.all_gather(torch.cat([x[:take], x[-take:]], 0))
    r = shard.mesh.rank
    zeros = torch.zeros_like(x[:take])
    from_above = strips[r - 1][take:] if r > 0 else zeros
    from_below = strips[r + 1][:take] if r < shard.n - 1 else zeros
    ext = torch.cat([from_above, x, from_below], 0)
    if take < halo:
        ext = _edge_pad_rows(ext, halo - take)
    return ext


def ext_row_index(gy, halo: int, shard: RowShard | None, h: int):
    """Global row index -> row index into an extend_rows() result: gy is
    clamped to the framebuffer, then to the reachable extended range."""
    full_h = shard.full_h if shard is not None else h
    y0 = shard.y0 if shard is not None else 0
    gy = torch.clamp(gy, 0, full_h - 1)
    return torch.clamp(gy - y0 + halo, 0, h + 2 * halo - 1)


def global_y0(shard: RowShard | None) -> int:
    return 0 if shard is None else shard.y0


def full_height(shard: RowShard | None, h: int) -> int:
    return h if shard is None else shard.full_h


def sub_shard(shard: RowShard | None, scale: int, sub_h: int) -> RowShard | None:
    """The band of a 1/scale grid (shard_h % scale == 0): y0 and the frame
    height divided by ``scale``, ``sub_h`` rows."""
    if shard is None:
        return None
    return shard._replace(y0=shard.y0 // scale, shard_h=sub_h, full_h=shard.full_h // scale)
