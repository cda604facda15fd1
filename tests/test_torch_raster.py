"""Tile raster + fused resolve: the port's plain version of the kernel
against the JAX Pallas kernel (interpret mode on the CPU), the port's
record/worklist builders against the JAX ones, the CUDA kernels' work-unit
split and their strip-culled, order-free merge (emulated in plain PyTorch)
against the plain versions, and — on a GPU — the CUDA kernel against its
plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.ops import culling as jcull
from hobbyrenderer_tpu.ops import raster as jras
from hobbyrenderer_tpu.ops import raster_pallas as jrp
from hobbyrenderer_tpu.scene import make_default_cube_scene, make_stress_scene
from hobbyrenderer_tpu.scene.camera import Camera
from hobbyrenderer_tpu.scene.gpu import build_scene_gpu as jax_build_scene_gpu
from hobbyrenderer_tpu.utils import math as hm
from hobbyrenderer_tpu_torch.config import Config
from hobbyrenderer_tpu_torch.ops import raster as tras
from hobbyrenderer_tpu_torch.ops import raster_kernel as trk
from hobbyrenderer_tpu_torch.renderer import Renderer as TorchRenderer
from hobbyrenderer_tpu_torch.scene.gpu import build_scene_gpu as torch_build_scene_gpu
from tests.torch_parity import same_mesh_cooker

SCENES = {"cube": make_default_cube_scene, "stress:2": lambda: make_stress_scene(grid=2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test workers on one machine: one torch thread
    each keeps the plain versions' many small ops from oversubscribing the
    cores (each op's thread team otherwise waits on descheduled threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _same_mesh_cooker():
    same_mesh_cooker()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel); run by chip_smoke.py on the card")
    return torch.device("cuda")


def _vc_torch(vc, device="cpu"):
    out = {}
    for k, v in vc.items():
        a = np.asarray(v)
        if a.ndim == 0:
            out[k] = int(a) if a.dtype.kind in "iu" else float(a)
        elif k == "viewport":
            out[k] = (float(a[0]), float(a[1]))
        else:
            out[k] = torch.as_tensor(a.astype(np.float32), device=device)
    out["frustum_planes"] = torch.as_tensor(
        hm.extract_frustum_planes(np.asarray(vc["view_proj"], np.float32)), device=device)
    return out


def _setup(name, w, h):
    scene = SCENES[name]()
    cam = Camera(None, w, h)
    cam.position = scene.center + np.asarray([0.6, 0.5, 1.2], np.float32) * scene.radius * 1.5
    cam.look_at(scene.center)
    vc = cam.view_constants(0)
    jg = jax_build_scene_gpu(scene)
    cull = jcull.cull_pairs(jg, vc, alpha_mask=jnp.asarray([True, True, False]))
    slots, _ = jcull.compact_mask(cull["mask"], int(jg.lod0_pair_capacity))
    return scene, vc, jg, slots


def _jax_kernel_run(monkeypatch, jg, vc, slots, w, h):
    """JAX rasterize through the Pallas kernel (interpret mode), capturing
    the kernel's inputs and outputs."""
    seen = {}
    orig = jrp.raster_resolve_tiles

    def spy(records, work_tile, work_slot, **kw):
        out = orig(records, work_tile, work_slot, **kw)
        seen.update(records=np.array(records), work_tile=np.array(work_tile),
                    work_slot=np.array(work_slot), tiles=kw["tiles"], tx=kw["tx"],
                    out=[np.array(o) for o in out])
        return out

    monkeypatch.setattr(jrp, "raster_resolve_tiles", spy)
    ro, _aux, attr = jras.rasterize(jg, vc, slots, w, h, backend="pallas",
                                    resolve_attrs=True)
    return seen, ro, np.asarray(attr)


def _compare(d_a, v_a, at_a, d_b, v_b, at_b):
    np.testing.assert_allclose(d_a, d_b, atol=1e-4)
    mismatch = np.mean(v_a != v_b)
    assert mismatch < 0.01, mismatch
    agree = (v_a == v_b) & (v_a >= 0)
    np.testing.assert_allclose(at_a[agree], at_b[agree], atol=1e-4)
    return agree


@pytest.mark.parametrize("name", list(SCENES))
def test_plain_k1_matches_pallas_kernel(monkeypatch, name):
    w, h = 128, 96
    _scene, vc, jg, slots = _setup(name, w, h)
    seen, _ro, _attr = _jax_kernel_run(monkeypatch, jg, vc, slots, w, h)
    rec = torch.as_tensor(seen["records"])
    wt = torch.as_tensor(seen["work_tile"])
    ws = torch.as_tensor(seen["work_slot"])
    d, v, a = trk.raster_resolve_tiles(rec, wt, ws, tiles=seen["tiles"], tx=seen["tx"])
    jd, jv, ja = seen["out"]
    agree = _compare(jd, jv, np.moveaxis(ja, 1, 2), d.numpy(), v.numpy(),
                     np.moveaxis(a.numpy(), 1, 2))
    assert agree.sum() > 200, "degenerate view: too few pixels drawn"


@pytest.mark.parametrize("name", list(SCENES))
def test_port_rasterize_matches_jax(monkeypatch, name):
    """The whole kernel path: transform, triangle expansion, records,
    worklist, raster + resolve, untiling."""
    w, h = 128, 96
    scene, vc, jg, slots = _setup(name, w, h)
    seen, ro, jattr = _jax_kernel_run(monkeypatch, jg, vc, slots, w, h)
    tg = torch_build_scene_gpu(scene, "cpu")
    tslots = torch.as_tensor(np.asarray(slots).astype(np.int64))
    out, attr = tras.rasterize(tg, _vc_torch(vc), tslots, w, h)
    _compare(np.asarray(ro.depth), np.asarray(ro.visid), jattr,
             out.depth.numpy(), out.visid.numpy(), attr.numpy())
    assert int(out.overflow) == int(np.asarray(ro.overflow))


def test_worklist_matches_jax():
    w, h = 128, 96
    scene, vc, jg, slots = _setup("stress:2", w, h)
    slot_valid = slots >= 0
    screen, _z, _w, vert_ok, ml, _p = jras._transform_meshlet_vertices(jg, vc, slots, slot_valid)
    sub = jnp.clip((jnp.where(slot_valid, jg.ml_tri_count[ml], 1) + 31) // 32, 1, 3)
    cap = 2 * max(8 * slots.shape[0], 4096)
    jt, js, jc, jo = jras.build_worklist(screen, vert_ok, slot_valid, w, h, cap,
                                         ty0=0, ty_count=-(-h // 32),
                                         sub_count=sub, n_sub=3)
    tt, ts, tc, to = tras.build_worklist(
        torch.as_tensor(np.asarray(screen)), torch.as_tensor(np.asarray(vert_ok)),
        torch.as_tensor(np.asarray(slot_valid)), w, h, cap,
        sub_count=torch.as_tensor(np.asarray(sub).astype(np.int64)), n_sub=3)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(tc) == int(jc) and int(to) == int(jo)
    assert int(tc) > 0


def test_empty_worklist_clears_tiles():
    T, tx = 4, 2
    rec = torch.zeros((3, 32, 128))
    wt = torch.full((8,), T, dtype=torch.int32)
    ws = torch.full((8,), -1, dtype=torch.int32)
    d, v, a = trk.raster_resolve_tiles(rec, wt, ws, tiles=T, tx=tx)
    assert d.shape == (T, 1024) and v.shape == (T, 1024) and a.shape == (T, 16, 1024)
    assert float(d.abs().max()) == 0.0 and int(v.max()) == -1 and float(a.abs().max()) == 0.0


@pytest.mark.parametrize("unit_items", [1, 2, 3, 8])
def test_split_units_covers_every_item_once_in_order(unit_items):
    rng = np.random.default_rng(unit_items)
    counts = rng.choice([0, 0, 1, 2, 5, 17, 40], size=37)
    counts[0], counts[-1] = 0, 23                  # empty and busy tiles at the ends
    tile_start = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32)
    units = trk.split_units(tile_start, unit_items)
    assert units.dtype == torch.int32 and units.shape[1] == 4
    # the queue order: split tiles' units first, then the tiles of one unit
    single = (units[:, 3] == 1).tolist()
    assert single == sorted(single)
    items = [list(range(j0, j0 + n)) for _, j0, n, _ in sorted(units.tolist(), key=lambda u: u[1])]
    assert [j for js in items for j in js] == list(range(int(counts.sum())))
    for t, j0, n, of_tile in units.tolist():
        assert tile_start[t] <= j0 and j0 + n <= tile_start[t + 1] and 0 < n <= unit_items
        assert of_tile == -(-int(counts[t]) // unit_items)
    per_tile = np.bincount(units[:, 0].numpy(), minlength=len(counts))
    np.testing.assert_array_equal(per_tile, -(-counts // unit_items))
    assert len(units) <= trk._max_units(int(counts.sum()) + 11, len(counts), unit_items)


def _unit_merge(records, work_tile, work_slot, *, tiles, tx, unit_items):
    """The kernels' algorithm in plain PyTorch: the worklist cut by
    split_units (empty tiles cleared); in each unit, per pixel, the deepest
    inside row among those that pass the strip test of the pixel's row
    (items, then rows, in order; strictly deeper wins); the units of a tile
    merged by the largest packed key (depth bits << 32 | ~(item * 32 +
    row)), in reverse unit order to show that the order does not matter.
    Returns depth and visid."""
    units = trk.split_units(trk._tile_start(work_tile, tiles), unit_items)
    p = torch.arange(trk.PIX)
    xl = (p % 32).to(torch.float32)[None, :]
    yl = (p // 32).to(torch.float32)[None, :]
    keys = torch.zeros((tiles, trk.PIX), dtype=torch.int64)
    for t, j0, n, _ in reversed(units.tolist()):
        oxf = torch.tensor([[[float((t % tx) * 32) + 0.5]]])
        oyf = torch.tensor([[[float((t // tx) * 32) + 0.5]]])
        best_z = torch.zeros(trk.PIX)
        best_i = torch.full((trk.PIX,), -1, dtype=torch.int64)
        for j in range(j0, j0 + n):
            A = records[int(work_slot[j])][:, :9]                     # (32, 9)
            keep = ~trk._rows_outside_strips(A[None], oxf, oyf)[0]    # (rows, strips)
            ox, oy = oxf[0], oyf[0]
            l1 = trk._plane_eval(A, ox, oy, xl, yl, 0)
            l2 = trk._plane_eval(A, ox, oy, xl, yl, 3)
            z = trk._plane_eval(A, ox, oy, xl, yl, 6)
            inside = (l1 >= 0.0) & (l2 >= 0.0) & (l1 + l2 <= 1.0) & keep[:, p // 32]
            for r in range(32):
                win = inside[r] & (z[r] > best_z)
                best_z = torch.where(win, z[r], best_z)
                best_i = torch.where(win, j * 32 + r, best_i)
        zbits = best_z.view(torch.int32).to(torch.int64)
        key = torch.where(best_i >= 0, (zbits << 32) | (0xFFFFFFFF - best_i), 0)
        keys[t] = torch.maximum(keys[t], key)
    won = keys > 0
    depth = torch.where(won, (keys >> 32).to(torch.int32).view(torch.float32), 0.0)
    idx = 0xFFFFFFFF - (keys & 0xFFFFFFFF)
    slot = work_slot[torch.where(won, idx // 32, 0)].to(torch.int64)
    visid = torch.where(won, slot * 32 + idx % 32, -1).to(torch.int32)
    return depth, visid


_WORKLISTS = {}


def _first_raster_call(name, tmp_path):
    """The K1 inputs of the Raster pass of the port's first frame of the
    scene at 96x64 on the CPU."""
    if name not in _WORKLISTS:
        seen = []
        orig = trk.raster_resolve_tiles

        def spy(records, work_tile, work_slot, **kw):
            seen.append((records, work_tile, work_slot, kw))
            return orig(records, work_tile, work_slot, **kw)

        r = TorchRenderer(Config(scene=name, width=96, height=64, cache_dir=str(tmp_path)),
                          device="cpu")
        trk.raster_resolve_tiles = spy
        try:
            r.render_frame()
        finally:
            trk.raster_resolve_tiles = orig
            r.shutdown()
        _WORKLISTS[name] = seen[0]
    return _WORKLISTS[name]


def _with_ties(records, work_tile, work_slot, tiles, tx):
    """The worklist with ties at equal depth: a copy of every third item's
    chunk under a new slot, one copy right after its item and the next right
    before it; and, first in the first drawn tile, a chunk of 32 copies of
    one of that tile's winning rows. Returns the new records, work_tile,
    work_slot, and the id (slot * 32) that the first drawn pixel must take."""
    n = int((work_tile < tiles).sum())
    S = records.shape[0]
    _, vis = trk.raster_tiles_reference(records, work_tile, work_slot, tiles=tiles, tx=tx)
    t0 = int(torch.nonzero((vis >= 0).any(1))[0])
    w = int(vis[t0][vis[t0] >= 0][0])
    picked = torch.arange(0, n, 3)
    same_row = records[w // 32, w % 32].expand(32, -1)
    records = torch.cat([records, records[work_slot[picked].long()], same_row[None]])
    first = int(torch.searchsorted(work_tile[:n].contiguous(), torch.tensor(t0, dtype=torch.int32)))
    key = torch.cat([torch.arange(n) * 4,
                     picked * 4 + torch.where(torch.arange(picked.shape[0]) % 2 == 0, 1, -1),
                     torch.tensor([4 * first - 2])])
    tile = torch.cat([work_tile[:n], work_tile[picked], torch.tensor([t0], dtype=torch.int32)])
    slot = torch.cat([work_slot[:n], S + torch.arange(picked.shape[0] + 1, dtype=torch.int32)])
    order = torch.argsort(key)
    pad = work_tile.shape[0] - n
    return (records, torch.cat([tile[order], torch.full((pad,), tiles, dtype=torch.int32)]),
            torch.cat([slot[order], torch.full((pad,), -1, dtype=torch.int32)]),
            (S + picked.shape[0]) * 32)


@pytest.mark.parametrize("unit_items", [1, 2])
@pytest.mark.parametrize("ties", [False, True], ids=["as_drawn", "ties"])
@pytest.mark.parametrize("name", ["stress:2", "stress:4"])
def test_unit_merge_matches_plain(tmp_path, name, ties, unit_items):
    """The kernels' split / strip-cull / packed-key merge, emulated, gives
    the plain versions' depth and visid bit for bit, split tiles included."""
    records, work_tile, work_slot, kw = _first_raster_call(name, tmp_path)
    tiles = kw["tiles"]
    if ties:
        S = records.shape[0]
        records, work_tile, work_slot, same_id = _with_ties(records, work_tile, work_slot,
                                                            **kw)
    n_per_tile = torch.bincount(work_tile.long(), minlength=tiles + 1)[:tiles]
    assert int(n_per_tile.max()) > 2 * unit_items, "no tile is split"
    d, v = _unit_merge(records, work_tile, work_slot, unit_items=unit_items, **kw)
    rd, rv = trk.raster_tiles_reference(records, work_tile, work_slot, **kw)
    assert torch.equal(d, rd) and torch.equal(v, rv)
    assert float((rd > 0).float().mean()) > 0.3, "degenerate view"
    if ties:
        # the earlier of two equal items wins: some copies placed first won
        copies = (rv >= S * 32) & (rv < same_id)
        assert bool(copies.any())
        # the lowest of 32 equal rows wins, at the pixel whose row they copy
        assert int(rv[(rv >= same_id) & (rv % 32 != 0)].numel()) == 0
        assert bool((rv == same_id).any())


def test_bench_raster_counts_the_work(tmp_path):
    """bench_raster's count of a call (shared with chip_smoke.py): the units
    and split tiles that split_units makes, the (row, pixel row) pairs the
    strip test keeps, and a bound no less than writing the outputs once."""
    from hobbyrenderer_tpu_torch import bench_raster
    records, work_tile, work_slot, kw = _first_raster_call("stress:2", tmp_path)
    tiles = kw["tiles"]
    st = bench_raster.call_stats(records, work_tile, work_slot, **kw)
    units = trk.split_units(trk._tile_start(work_tile, tiles), trk.UNIT_ITEMS)
    assert st["units"] == units.shape[0] and st["items"] == int(units[:, 2].sum())
    assert st["split_tiles"] == len(set(units[units[:, 3] > 1, 0].tolist()))
    t = work_tile[:st["items"]].long()
    oxf = ((t % kw["tx"]) * 32).to(torch.float32)[:, None, None] + 0.5
    oyf = ((t // kw["tx"]) * 32).to(torch.float32)[:, None, None] + 0.5
    A = records[work_slot[:st["items"]].long()][..., :9]
    kept = int((~trk._rows_outside_strips(A, oxf, oyf)).sum())
    assert st["strip_rows"] == kept and 0 < kept < st["strip_rows_all"] == st["items"] * 1024
    _, visid, _ = trk.raster_resolve_tiles_reference(records, work_tile, work_slot, **kw)
    k1 = bench_raster.raster_bound(records, work_tile, work_slot, visid, k1=True, **kw)
    k5 = bench_raster.raster_bound(records, work_tile, work_slot, visid, k1=False, **kw)
    assert k1[2] > tiles * 1024 * 4 * 18 and k5[2] > tiles * 1024 * 8
    assert k1[3] > k5[3] == kept * 32 * bench_raster.OPS_A_PIXEL_ROW
    assert k1[0] >= k5[0] > 0


@pytest.mark.cuda
def test_cuda_k1_matches_plain(cuda_device, monkeypatch):
    w, h = 256, 192
    _scene, vc, jg, slots = _setup("stress:2", w, h)
    seen, _ro, _attr = _jax_kernel_run(monkeypatch, jg, vc, slots, w, h)
    args = [torch.as_tensor(seen[k]).to(cuda_device) for k in ("records", "work_tile", "work_slot")]
    kw = dict(tiles=seen["tiles"], tx=seen["tx"])
    n0 = trk.launches
    got = [trk.raster_resolve_tiles(*args, **kw) for _ in range(3)]
    torch.cuda.synchronize()
    assert trk.launches == n0 + 3
    d, v, a = got[0]
    rd, rv, ra = trk.raster_resolve_tiles_reference(*args, **kw)
    assert torch.equal(d, rd) and torch.equal(v, rv)
    np.testing.assert_allclose(a.cpu().numpy(), ra.cpu().numpy(), atol=1e-4)
    assert all(torch.equal(x, y) for g in got[1:] for x, y in zip(got[0], g))
