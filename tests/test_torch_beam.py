"""Any-hit occlusion: the port's plain version of the kernel (brute-force
Möller-Trumbore over the table's leaf triangles) against the JAX Pallas beam
kernel in interpret mode; the kernel's walk replayed in plain PyTorch
against the plain version, on coherent, jittered, sparsely masked
and incoherent rays; the walk's stack check; the port's jax-matching
bilinear resize; and — on a GPU — the CUDA kernel against its plain
version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.ops import beam as jbeam
from hobbyrenderer_tpu_torch.ops import beam as tbeam
from hobbyrenderer_tpu_torch.ops import bvh as tbvh
from hobbyrenderer_tpu_torch.ops.resize import resize_bilinear


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test workers on one machine: one torch thread
    each keeps the plain versions' many small ops from oversubscribing the
    cores (each op's thread team otherwise waits on descheduled threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel); run by chip_smoke.py on the card")
    return torch.device("cuda")


def _tri_soup(n, seed=0, spread=4.0, size=0.5):
    rng = np.random.default_rng(seed)
    c = (rng.random((n, 1, 3), np.float32) - 0.5) * spread
    v = c + (rng.random((n, 3, 3), np.float32) - 0.5) * size
    return v.astype(np.float32)


def _coherent_rays(H, W, seed=1, jitter=0.0):
    """Sun-shadow-like rays: origins on a jittered grid plane, one direction
    (optionally jittered per ray, the cone-sampled sun)."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-2.5, 2.5, W, dtype=np.float32)
    ys = np.linspace(-2.5, 2.5, H, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)
    o = np.stack([gx, np.full_like(gx, -2.0), gy], -1)
    o += rng.random(o.shape).astype(np.float32) * 0.02
    d = np.broadcast_to(np.asarray([0.08, 0.95, -0.2], np.float32), o.shape).copy()
    if jitter:
        d += rng.normal(0, jitter, d.shape).astype(np.float32)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _incoherent_rays(H, W, seed):
    """RTXDIGI-like visibility rays: origins on the grid plane, each aimed
    at its own random point of the soup's box, t_max just short of it."""
    o, _ = _coherent_rays(H, W, seed=seed)
    rng = np.random.default_rng(seed + 100)
    target = (rng.random((H, W, 3), np.float32) - 0.5) * 4.0
    v = target - o
    dist = np.linalg.norm(v, axis=-1)
    return o, (v / dist[..., None]).astype(np.float32), (dist - 1e-3).astype(np.float32)


def _sparse_majority_mask(H, W, seed):
    """RTXDI's second any-hit call masks each tile to the lanes of its
    second-most-common winner: a few scattered lanes a tile."""
    rng = np.random.default_rng(seed)
    key = torch.as_tensor(rng.integers(0, 5, (H, W)))
    match = tbeam.tile_majority_mask(key, H, W, exclude=-1)
    key2 = torch.where(match, -1, key)
    return tbeam.tile_majority_mask(key2, H, W, exclude=-1) & ~match


CASES = {
    "coherent": dict(n=900, seed=0, H=64, W=64, ray_seed=1, jitter=0.0),
    "jittered": dict(n=400, seed=7, H=32, W=64, ray_seed=5, jitter=0.05),
    "sparse_majority": dict(n=600, seed=2, H=64, W=64, ray_seed=3, jitter=0.02),
    "incoherent": dict(n=600, seed=5, H=64, W=32, ray_seed=8, jitter=None),
}
PALLAS_CASES = ("coherent", "jittered")


def _case_rays(c):
    """The case's packed rays (T, 8, 1024) and its btable, as torch tensors."""
    H, W = c["H"], c["W"]
    btable = torch.as_tensor(tbeam.beam_table(tbvh.build_bvh(_tri_soup(c["n"], c["seed"])).table))
    if c["jitter"] is None:
        o, d, tm = _incoherent_rays(H, W, c["ray_seed"])
        tm = torch.as_tensor(tm)
    else:
        o, d = _coherent_rays(H, W, seed=c["ray_seed"], jitter=c["jitter"])
        tm = torch.full((H, W), 50.0)
    active = torch.ones((H, W), dtype=torch.bool)
    active[3::11, :] = False
    if c is CASES["sparse_majority"]:
        active = _sparse_majority_mask(H, W, c["ray_seed"])
    rays = tbeam.pack_rays_tiles(torch.as_tensor(o), torch.as_tensor(d), tm, active, H, W)
    return btable, rays


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_plain_k4_matches_pallas_kernel(case):
    c = CASES[case]
    H, W = c["H"], c["W"]
    tris = _tri_soup(c["n"], seed=c["seed"])
    btable = tbeam.beam_table(tbvh.build_bvh(tris).table)
    o, d = _coherent_rays(H, W, seed=c["ray_seed"], jitter=c["jitter"])
    t_max = np.full((H, W), 50.0, np.float32)
    t_max[::7, ::5] = 1e-4                      # no hit possible
    active = np.ones((H, W), bool)
    active[3::11, :] = False
    rays = jbeam.pack_rays_tiles(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
                                 jnp.asarray(active), H, W)
    jocc, jovf = jbeam.beam_any_hit_tiles(jnp.asarray(btable), rays,
                                          interpret=jax.default_backend() != "tpu")
    jocc, jovf = np.asarray(jocc), np.asarray(jovf)
    trays = tbeam.pack_rays_tiles(torch.as_tensor(o), torch.as_tensor(d),
                                  torch.as_tensor(t_max), torch.as_tensor(active), H, W)
    np.testing.assert_array_equal(trays.numpy(), np.asarray(rays))
    occ, ovf = tbeam.beam_any_hit_tiles(torch.as_tensor(btable), trays)
    occ = occ.numpy()
    ok_tiles = jovf < 0.5
    assert ok_tiles.all(), "degenerate case: the beam frontier overflowed"
    act_t = trays[:, 7].numpy() > 0.5
    assert 0.05 < jocc[act_t].mean() < 0.95, "degenerate case: all or nothing occluded"
    # active lanes agree exactly; the Pallas kernel does not mask inactive
    # lanes (its callers give them t_max = 1e-4), the port reports 0 there
    cmp = ok_tiles[:, None] & act_t
    np.testing.assert_array_equal(occ[cmp], jocc[cmp])
    assert not occ[~act_t].any()
    assert not ovf.numpy().any()


@pytest.mark.parametrize("case", list(CASES))
def test_beam_walk_rows_matches_plain(case):
    """The kernel's walk, replayed in plain PyTorch, gives the plain
    version's occlusion; the rows it reads include the root and each read
    row's parent, and are fewer than the table's; the kernel's list holds
    every live lane once, each tile's in the 8x4 packet order."""
    c = CASES[case]
    btable, rays = _case_rays(c)
    occ, seen, work = tbeam.beam_walk(btable, rays)
    ref, _ = tbeam.beam_any_hit_tiles_reference(btable, rays)
    live = (rays[:, 7] > 0.5) & (rays[:, 6] > 1e-4)
    assert torch.equal(occ, ref) and 0.05 < float(ref[live].mean()) < 0.95
    rows = torch.nonzero(seen).flatten()
    assert bool(seen[0]) and bool(seen[(rows[rows > 0] - 1) // 4].all())
    assert 1 < rows.numel() < seen.numel()
    lanes = tbeam.live_lanes(rays)
    assert torch.equal(torch.sort(lanes).values, torch.nonzero(live.flatten()).flatten())
    rank = torch.argsort(tbeam.packet_order())               # tile lane -> place in the order
    tile, lane = lanes // tbeam.PIX, lanes % tbeam.PIX
    assert bool((torch.diff(tile) >= 0).all())
    same = torch.diff(tile) == 0
    assert bool((torch.diff(rank[lane])[same] > 0).all())
    assert work["live"] == lanes.numel()
    assert work["interior_rows"] + work["leaf_rows"] == work["lane_steps"] >= rows.numel()
    assert 1 < work["max_steps"] <= work["lane_steps"]
    assert 0 < work["record_tests"] and 0 < work["box_tests"]
    if case == "sparse_majority":
        assert float(live.float().mean()) < 0.3


def test_packet_order_is_8x4_blocks():
    """The packet order is a permutation of the tile's lanes in which each
    run of 32 is one 8x4 pixel block; beam_table's leaf marker agrees with
    the leaf start the kernel computes from the row count."""
    order = tbeam.packet_order()
    assert torch.equal(torch.sort(order).values, torch.arange(tbeam.PIX))
    blk = order.reshape(32, 32)
    x, y = blk % tbeam.TILE, blk // tbeam.TILE
    assert bool(((x.amax(1) - x.amin(1)) == 7).all() and ((y.amax(1) - y.amin(1)) == 3).all())
    btable, _ = _case_rays(CASES["coherent"])
    n = btable.shape[0]
    marker = btable[:, 127] > 0.5
    assert torch.equal(marker, torch.arange(n) >= tbeam._leaf_start(n))


def test_too_deep_table_raises():
    """A table deeper than the stack holds raises in the wrapper and in the
    replay instead of dropping children; the check reads only the row
    count, so an expanded zero tensor serves. The stress table's 349,525
    rows (10 levels) need 28 entries."""
    assert tbeam.tree_depth(1) == 1 and tbeam.tree_depth(5) == 2 and tbeam.tree_depth(6) == 3
    assert tbeam.tree_depth(349_525) == 10
    tbeam.check_stack(349_525)
    levels = (tbeam.STACK - 1) // 3 + 1        # the deepest tree the stack holds
    deepest = (4 ** levels - 1) // 3
    tbeam.check_stack(deepest)
    too_deep = torch.zeros(1, 128).expand(deepest + 1, 128)
    rays = torch.zeros(1, 8, tbeam.PIX)
    with pytest.raises(ValueError, match="stack"):
        tbeam.beam_any_hit_tiles(too_deep, rays)
    with pytest.raises(ValueError, match="stack"):
        tbeam.beam_walk(too_deep, rays)


def test_beam_any_hit_image_roundtrip():
    H, W = 40, 72                                # partial edge tiles
    tris = _tri_soup(300, seed=3)
    btable = torch.as_tensor(tbeam.beam_table(tbvh.build_bvh(tris).table))
    o, d = _coherent_rays(H, W, seed=2)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    tm = torch.full((H, W), 50.0)
    act = torch.ones((H, W), dtype=torch.bool)
    occ, n_ovf = tbeam.beam_any_hit(btable, o, d, tm, act, H, W)
    assert occ.shape == (H, W) and occ.dtype == torch.bool and int(n_ovf) == 0
    occ_off, _ = tbeam.beam_any_hit(btable, o, d, tm, torch.zeros_like(act), H, W)
    assert not occ_off.any()
    occ_short, _ = tbeam.beam_any_hit(btable, o, d, torch.zeros((H, W)), act, H, W)
    assert not occ_short.any()
    assert occ.any()


# the resizes the frame runs: sun-shadow mask (shadow_scale 2) and the
# strided sky (scale 4), at the CPU test sizes and at 1080p
RESIZES = [((24, 32), (48, 64)), ((32, 48), (64, 96)), ((540, 960), (1080, 1920)),
           ((12, 16, 3), (48, 64, 3)), ((270, 480, 3), (1080, 1920, 3)),
           ((33, 47), (67, 95))]


@pytest.mark.parametrize("src,dst", RESIZES, ids=[f"{s}->{d}" for s, d in RESIZES])
def test_resize_bilinear_matches_jax(src, dst):
    x = np.random.default_rng(0).random(src, np.float32) * 4.0
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst, method="bilinear"))
    got = resize_bilinear(torch.as_tensor(x), dst[0], dst[1]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_cuda_k4_matches_plain(cuda_device):
    H, W = 128, 128
    tris = _tri_soup(3000, seed=4)
    btable = torch.as_tensor(tbeam.beam_table(tbvh.build_bvh(tris).table)).to(cuda_device)
    o, d = _coherent_rays(H, W, seed=9, jitter=0.02)
    rays = tbeam.pack_rays_tiles(torch.as_tensor(o), torch.as_tensor(d),
                                 torch.full((H, W), 50.0), torch.ones((H, W), dtype=torch.bool),
                                 H, W).to(cuda_device)
    n0 = tbeam.launches
    occ, ovf = tbeam.beam_any_hit_tiles(btable, rays)
    torch.cuda.synchronize()
    assert tbeam.launches == n0 + 1
    ref, _ = tbeam.beam_any_hit_tiles_reference(btable, rays)
    assert torch.equal(occ, ref)
    assert not ovf.any()
    assert all(torch.equal(occ, tbeam.beam_any_hit_tiles(btable, rays)[0]) for _ in range(2))
