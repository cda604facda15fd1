"""The order K6's CUDA kernel (csrc/closest_blocks.cu) runs in, emulated in
plain PyTorch and held to its plain version ``closest_hit_blocks_reference``.

The kernel reads the cull bound cur_hi once a level, runs all of the
level's box tests at once and appends the hits by a cumulative sum (the
first FCAP - 1 in (row, child) order kept), then folds the level's leaf rows
group by group; a block's lanes are split over C CTAs whose bounds and
cur_hi are reduced part by part. That equals the plain version's group by
group walk only because every level's frontier ascends and its interior
rows come before its leaf rows, so no leaf fold of a level precedes one of
its box tests: the emulation asserts that on every level it visits.

Scenes: tests/test_torch_trace.py's 700-triangle soup and rays (2 blocks),
with the full frontier and cut to 64 nodes (both blocks overflow); and a
heap whose row count is not a full 4-ary tree's, so that a level holds
interior rows and leaf rows and one group holds both. Outputs must be
``torch.equal``. The kernel's warp-level record cull is emulated too, on
the soup's incoherent rays and on camera rays: no record it drops passes
h on a lane of its warp. On a GPU, the kernel itself on the second
scene."""

import numpy as np
import pytest
import torch

from hobbyrenderer_tpu_torch.ops import beam as tbeam
from hobbyrenderer_tpu_torch.ops import bvh as tbvh
from hobbyrenderer_tpu_torch.ops import trace as ttrace
from hobbyrenderer_tpu_torch.ops import trace_kernel as tk
from test_torch_trace import _rays, _tri_soup

PIX = tk.PIX


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def emulate_kernel(btable, rays, t_min=1e-4, C=4, fcap=tk.FCAP, trail=None):
    """K6 in the kernel's order (see the module docstring): the six outputs
    of ``closest_hit_blocks``. ``trail``, if given, gets one (block, level,
    interior rows, leaf rows, hits) a level."""
    T = rays.shape[0]
    I = tbeam._leaf_start(btable.shape[0])
    NT = PIX // C
    parts = [slice(q * NT, (q + 1) * NT) for q in range(C)]
    big = torch.tensor(tk.BIG)
    chi = torch.arange(4)
    outs = [[] for _ in range(5)]
    ovf = torch.zeros(T)
    for b in range(T):
        ray = rays[b]
        act = ray[7] > 0.5
        # the bounds: each CTA's lanes, then over the cluster
        lo = torch.stack([torch.where(act[s], ray[:6, s], big).amin(1) for s in parts]).amin(0)
        hi = torch.stack([torch.where(act[s], ray[:6, s], -big).amax(1) for s in parts]).amax(0)
        any_act = any(bool(act[s].any()) for s in parts)
        olo, dlo, ohi, dhi = lo[None, :3], lo[None, 3:], hi[None, :3], hi[None, 3:]
        pos, neg = dlo > tk.EPS, dhi < -tk.EPS
        ilo = torch.where(pos, 1.0 / torch.clamp(dhi, min=tk.EPS),
                          1.0 / torch.clamp(dlo, max=-tk.EPS))
        ihi = torch.where(pos, 1.0 / torch.clamp(dlo, min=tk.EPS),
                          1.0 / torch.clamp(dhi, max=-tk.EPS))
        bb = (olo, ohi, dlo, dhi, pos | neg, ilo, ihi)
        best = [ray[6].clone(), torch.full((PIX,), -1.0), torch.zeros(PIX), torch.zeros(PIX),
                torch.zeros(PIX)]
        ids = torch.zeros(1 if any_act else 0, dtype=torch.int64)
        level = 0
        while ids.numel():
            cnt = ids.numel()
            isleaf = ids >= I
            assert bool((ids[1:] > ids[:-1]).all()), "the frontier does not ascend"
            assert torch.equal(isleaf, btable[ids, 127] > 0.5), "leaf marker != id >= I"
            n_int = int((~isleaf).sum())
            assert not bool(isleaf[:n_int].any()), "a leaf row precedes an interior row"
            nxt = ids[:0]
            n_hits = 0
            if n_int:
                # cur_hi once a level: each CTA's active lanes, then the cluster's
                cur_hi = torch.stack([torch.where(act[s], best[0][s], 0.0).amax()
                                      for s in parts]).amax()
                G = -(-n_int // tk.GW)
                rows = torch.zeros((G * tk.GW, 128))
                rows[:n_int] = btable[ids[:n_int]]
                rowok = (torch.arange(G * tk.GW) < n_int).reshape(G, tk.GW)
                hits = tk._child_hits(rows.reshape(G, tk.GW, 128), rowok,
                                      torch.zeros_like(rowok), cur_hi.expand(G),
                                      tuple(x.expand(G, 3) for x in bb))
                hits = hits.reshape(-1)[:4 * n_int]              # (row, child) order
                n_hits = int(hits.sum())
                at = torch.cumsum(hits.to(torch.int64), 0) - 1
                child = (4 * ids[:n_int, None] + 1 + chi).reshape(-1)
                nxt = child[hits & (at < fcap - 1)]
                if n_hits > fcap - 1:
                    ovf[b] = 1.0
            # the leaf rows, a group of 8 frontier positions at a time, each
            # CTA's lanes on their own
            for g in range(n_int // tk.GW, -(-cnt // tk.GW)):
                p0 = g * tk.GW
                r = torch.arange(p0, p0 + tk.GW)
                leaf = ((r >= n_int) & (r < cnt))[None]
                B = torch.zeros((1, tk.GW, 128))
                B[leaf] = btable[ids[r[leaf[0]]]]
                for s in parts:
                    part = [x[None, s] for x in best]
                    tk._leaf_fold(B, leaf, ray[None, :, s], part, t_min)
                    for i in range(5):
                        best[i][s] = part[i][0]
            if trail is not None:
                trail.append((b, level, n_int, cnt - n_int, n_hits))
            ids = nxt
            level += 1
        for i in range(5):
            outs[i].append(best[i])
    return (*[torch.stack(x) for x in outs], ovf)


def _odd_heap(n_rows=30, seed=3):
    """A 4-wide heap of n_rows rows, not a full tree's count: rows below
    ``_leaf_start`` are interior (child boxes from their subtrees; a child
    past the table is an empty, inverted box), the others leaves of 4
    triangles (every 7th record empty, tid -1). -> beam_table rows."""
    I = tbeam._leaf_start(n_rows)
    rng = np.random.default_rng(seed)
    table = np.zeros((n_rows, 40), np.float32)
    lo = np.full((n_rows, 3), 1e30, np.float32)
    hi = np.full((n_rows, 3), -1e30, np.float32)
    tid = 0
    for q in range(I, n_rows):
        for k in range(4):
            c = (rng.random(3, np.float32) - 0.5) * 4.0
            v = c + (rng.random((3, 3), np.float32) - 0.5) * 0.8
            if (4 * q + k) % 7 == 0:
                table[q, 10 * k:10 * k + 10] = np.r_[v[0], v[1] - v[0], v[2] - v[0], -1.0]
                continue
            table[q, 10 * k:10 * k + 10] = np.r_[v[0], v[1] - v[0], v[2] - v[0], tid]
            tid += 1
            lo[q] = np.minimum(lo[q], v.min(0))
            hi[q] = np.maximum(hi[q], v.max(0))
    for q in range(I - 1, -1, -1):
        for ch in range(4):
            c = 4 * q + 1 + ch
            if c < n_rows:
                table[q, 6 * ch:6 * ch + 6] = np.r_[lo[c], hi[c]]
                lo[q] = np.minimum(lo[q], lo[c])
                hi[q] = np.maximum(hi[q], hi[c])
            else:
                table[q, 6 * ch:6 * ch + 6] = np.r_[np.full(3, 1e30), np.full(3, -1e30)]
    return tbeam.beam_table(table), np.r_[lo[0], hi[0]].astype(np.float32)


def _soup_blocks():
    tris = _tri_soup(700)
    tb = tbvh.build_bvh(tris)
    btable = torch.as_tensor(tbeam.beam_table(tb.table))
    o, d, t_max, active = _rays(1500)
    rays, _ = ttrace.pack_rays_sorted(torch.as_tensor(o), torch.as_tensor(d),
                                      torch.as_tensor(t_max), torch.as_tensor(active),
                                      torch.as_tensor(tb.root_box))
    return btable, rays


def _odd_blocks():
    btable, root_box = _odd_heap()
    o, d, t_max, active = _rays(2 * PIX, seed=5)
    rays, _ = ttrace.pack_rays_sorted(torch.as_tensor(o), torch.as_tensor(d),
                                      torch.as_tensor(t_max), torch.as_tensor(active),
                                      torch.as_tensor(root_box))
    return torch.as_tensor(btable), rays


@pytest.mark.parametrize("fcap,C", [(tk.FCAP, 1), (tk.FCAP, 8), (64, 4), (64, 8)])
def test_kernel_order_equals_plain_on_the_soup(monkeypatch, fcap, C):
    """The 700-triangle soup: with the full frontier, and with the frontier
    cut to 64 nodes (both blocks overflow, on the level that cuts)."""
    btable, rays = _soup_blocks()
    monkeypatch.setattr(tk, "FCAP", fcap)
    trail = []
    got = emulate_kernel(btable, rays, C=C, fcap=fcap, trail=trail)
    ref = tk.closest_hit_blocks_reference(btable, rays)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert 0.02 < float((ref[1] >= 0).float().mean()) < 0.9, "degenerate case"
    if fcap == 64:
        assert ref[5].tolist() == [1.0, 1.0]
        assert any(h > fcap - 1 for *_, h in trail)
    else:
        assert ref[5].tolist() == [0.0, 0.0]
    # a full 4-ary heap: every level is all interior or all leaves
    assert all(n_int == 0 or n_leaf == 0 for _, _, n_int, n_leaf, _ in trail)
    assert any(n_leaf for _, _, _, n_leaf, _ in trail)


@pytest.mark.parametrize("fcap", [tk.FCAP, 8])
def test_kernel_order_equals_plain_on_a_mixed_level(monkeypatch, fcap):
    """A heap of 30 rows (interior rows 0..6): level 2 holds interior rows
    5 and 6 and leaf rows 7..20, and its first group holds both kinds; with
    the frontier cut to 8 nodes its box tests drop children."""
    btable, rays = _odd_blocks()
    monkeypatch.setattr(tk, "FCAP", fcap)
    trail = []
    got = emulate_kernel(btable, rays, C=4, fcap=fcap, trail=trail)
    ref = tk.closest_hit_blocks_reference(btable, rays)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert any(n_int and n_leaf for _, _, n_int, n_leaf, _ in trail), trail
    assert 0.05 < float((ref[1] >= 0).float().mean()) < 0.95, "degenerate case"
    assert bool((ref[5] > 0).any()) == (fcap == 8)


def warp_cull(btable, rays, t_min=1e-4):
    """The kernel's warp-level record cull (csrc/closest_blocks.cu,
    ``record_may_hit``) in plain PyTorch, every op rounded once as the
    kernel rounds it: for every warp of 32 lanes and every leaf record
    (T, 32, leaves, 4) whether the cull keeps it, and whether h holds for
    some active lane of the warp with t < t_max (a superset of the kernel's
    t < best t)."""
    f = lambda x: torch.tensor(x, dtype=torch.float32)        # noqa: E731
    I = tbeam._leaf_start(btable.shape[0])
    rec = btable[I:, :64].reshape(-1, 4, 16)[..., :10]          # (L, 4, 10)
    v0, e1, e2, tid = rec[..., 0:3], rec[..., 3:6], rec[..., 6:9], rec[..., 9]
    T = rays.shape[0]
    ray = rays.permute(0, 2, 1).reshape(T, 32, 32, 8)          # (T, warp, lane, 8)
    act = ray[..., 7] > 0.5
    big = f(tk.BIG)
    lo = torch.where(act[..., None], ray[..., :6], big).amin(2)   # (T, 32, 6)
    hi = torch.where(act[..., None], ray[..., :6], -big).amax(2)
    mag = torch.maximum(lo.abs(), hi.abs()).amax(-1)
    W = lambda x: x[:, :, None, None]                           # noqa: E731 (warp value)
    R = lambda x: x[None, None]                                 # noqa: E731 (record value)

    def mul_c(a, c):
        x, y = a[0] * c, a[1] * c
        return torch.minimum(x, y), torch.maximum(x, y)

    def mul_i(a, b):
        c = [a[0] * b[0], a[0] * b[1], a[1] * b[0], a[1] * b[1]]
        return (torch.minimum(torch.minimum(c[0], c[1]), torch.minimum(c[2], c[3])),
                torch.maximum(torch.maximum(c[0], c[1]), torch.maximum(c[2], c[3])))
    add_i = lambda a, b: (a[0] + b[0], a[1] + b[1])             # noqa: E731
    sub_i = lambda a, b: (a[0] - b[1], a[1] - b[0])             # noqa: E731
    o = [(W(lo[..., i]), W(hi[..., i])) for i in range(3)]
    d = [(W(lo[..., 3 + i]), W(hi[..., 3 + i])) for i in range(3)]
    E1 = [R(e1[..., i]) for i in range(3)]
    E2 = [R(e2[..., i]) for i in range(3)]
    p = [sub_i(mul_c(d[1], E2[2]), mul_c(d[2], E2[1])),
         sub_i(mul_c(d[2], E2[0]), mul_c(d[0], E2[2])),
         sub_i(mul_c(d[0], E2[1]), mul_c(d[1], E2[0]))]
    det = add_i(add_i(mul_c(p[0], E1[0]), mul_c(p[1], E1[1])), mul_c(p[2], E1[2]))
    sv = [(o[i][0] - R(v0[..., i]), o[i][1] - R(v0[..., i])) for i in range(3)]
    un = add_i(add_i(mul_i(sv[0], p[0]), mul_i(sv[1], p[1])), mul_i(sv[2], p[2]))
    q = [sub_i(mul_c(sv[1], E1[2]), mul_c(sv[2], E1[1])),
         sub_i(mul_c(sv[2], E1[0]), mul_c(sv[0], E1[2])),
         sub_i(mul_c(sv[0], E1[1]), mul_c(sv[1], E1[0]))]
    vn = add_i(add_i(mul_i(d[0], q[0]), mul_i(d[1], q[1])), mul_i(d[2], q[2]))
    tn = add_i(add_i(mul_c(q[0], E2[0]), mul_c(q[1], E2[1])), mul_c(q[2], E2[2]))
    pos = det[0] > 1e-12
    neg = det[1] < -1e-12
    amax = torch.where(pos, det[1], -det[0])

    def bary_out(n):
        n_pos, n_neg = n[0] > 0, n[1] < 0
        opp = torch.where(pos, n_neg, n_pos)
        same = torch.where(pos, n_pos, n_neg)
        amin = torch.where(n_pos, n[0], -n[1])
        return (opp & (amin > f(4e-7) * amax)) | (same & (amin > f(1.000001) * amax))
    big_in = torch.cat([v0, e1, e2], -1).abs().amax(-1)
    t_out = torch.where(pos, tn[1] <= 0, tn[0] >= 0) if t_min >= 0 else torch.zeros_like(pos)
    culled = (~(R(tid) >= 0)) | ((R(big_in) < 1e9) & (W(mag) < 1e9) & (
        ((det[0] >= -1e-12) & (det[1] <= 1e-12))
        | ((pos | neg) & (bary_out(un) | bary_out(vn) | t_out))))
    # h of every lane and record, the plain version's arithmetic, t < t_max
    L = ray[..., None, None, :]                                 # (T, 32, 32, 1, 1, 8)
    V = lambda x: x[None, None, None]                           # noqa: E731
    ox, oy, oz, dx, dy, dz, tmax = (L[..., i] for i in range(7))
    e1x, e1y, e1z = (V(e1[..., i]) for i in range(3))
    e2x, e2y, e2z = (V(e2[..., i]) for i in range(3))
    px, py, pz = dy * e2z - dz * e2y, dz * e2x - dx * e2z, dx * e2y - dy * e2x
    dt = e1x * px + e1y * py + e1z * pz
    okd = dt.abs() > 1e-12
    inv = torch.where(okd, 1.0 / dt, 0.0)
    sx, sy, sz = ox - V(v0[..., 0]), oy - V(v0[..., 1]), oz - V(v0[..., 2])
    u = (sx * px + sy * py + sz * pz) * inv
    qx, qy, qz = sy * e1z - sz * e1y, sz * e1x - sx * e1z, sx * e1y - sy * e1x
    vv = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    h = (okd & (u >= -1e-7) & (vv >= -1e-7) & (u + vv <= f(1.0 + 1e-7)) & (t > t_min)
         & (t < tmax) & (V(tid) >= 0) & act[..., None, None])
    return culled, h.any(2)


def _camera_blocks(btable_root, n=2 * PIX, seed=11):
    """Coherent rays: one origin outside the soup, directions on a small
    grid toward it (a camera's), sorted into blocks."""
    root = torch.as_tensor(btable_root)
    g = int(np.sqrt(n))
    yy, xx = np.meshgrid(np.linspace(-0.5, 0.5, g), np.linspace(-0.5, 0.5, n // g), indexing="ij")
    d = np.stack([xx.ravel(), yy.ravel(), np.ones(xx.size)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(np.array([[0.1, 0.2, -5.0]], np.float32), (d.shape[0], 1))
    tm = np.full(d.shape[0], 1e30, np.float32)
    rays, _ = ttrace.pack_rays_sorted(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tm),
                                      torch.ones(d.shape[0], dtype=torch.bool), root)
    return rays


@pytest.mark.parametrize("rays_of", ["incoherent", "camera"])
def test_warp_cull_never_drops_a_hit(rays_of):
    """The kernel's warp-level record cull on the 700-triangle soup: no
    record it drops for a warp passes h on any active lane of that warp.
    It drops every padding record (tid -1); of the triangles' records it
    drops most on coherent camera rays (measured 0.72), almost none on the
    incoherent set (1e-4), whose warps span all directions."""
    tris = _tri_soup(700)
    tb = tbvh.build_bvh(tris)
    btable = torch.as_tensor(tbeam.beam_table(tb.table))
    rays = _soup_blocks()[1] if rays_of == "incoherent" else _camera_blocks(tb.root_box)
    culled, h_any = warp_cull(btable, rays)
    assert int(h_any.sum()) > 10, "degenerate case"
    assert not bool((culled & h_any).any()), int((culled & h_any).sum())
    tid = btable[tbeam._leaf_start(btable.shape[0]):, :64].reshape(-1, 4, 16)[..., 9]
    real = (tid >= 0).expand_as(culled)
    assert bool(culled[~real].all())
    if rays_of == "camera":
        assert float(culled[real].float().mean()) > 0.6


@pytest.mark.cuda
def test_cuda_k6_on_a_mixed_level():
    """The CUDA kernel on the mixed-level heap against its plain version,
    bit for bit, three launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel); run by chip_smoke.py on the card")
    btable, rays = _odd_blocks()
    btable, rays = btable.cuda(), rays.cuda()
    ref = tk.closest_hit_blocks_reference(btable, rays)
    runs = [tk.closest_hit_blocks(btable, rays) for _ in range(3)]
    torch.cuda.synchronize()
    for got in runs:
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
