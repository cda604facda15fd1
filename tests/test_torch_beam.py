"""Any-hit occlusion: the port's plain version of the kernel (brute-force
Möller-Trumbore over the table's leaf triangles) against the JAX Pallas beam
kernel in interpret mode; the port's jax-matching bilinear resize; and — on
a GPU — the CUDA kernel against its plain version."""

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


CASES = {
    "coherent": dict(n=900, seed=0, H=64, W=64, ray_seed=1, jitter=0.0),
    "jittered": dict(n=400, seed=7, H=32, W=64, ray_seed=5, jitter=0.05),
}


@pytest.mark.parametrize("case", list(CASES))
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
    """The kernel's stack walk as a wavefront gives the plain version's
    occlusion; the rows it reads include the root and each read row's
    parent, and are fewer than the table's."""
    c = CASES[case]
    H, W = c["H"], c["W"]
    tris = _tri_soup(c["n"], seed=c["seed"])
    btable = torch.as_tensor(tbeam.beam_table(tbvh.build_bvh(tris).table))
    o, d = _coherent_rays(H, W, seed=c["ray_seed"], jitter=c["jitter"])
    active = torch.ones((H, W), dtype=torch.bool)
    active[3::11, :] = False
    rays = tbeam.pack_rays_tiles(torch.as_tensor(o), torch.as_tensor(d),
                                 torch.full((H, W), 50.0), active, H, W)
    occ, seen = tbeam.beam_walk_rows(btable, rays)
    ref, _ = tbeam.beam_any_hit_tiles_reference(btable, rays)
    assert torch.equal(occ, ref) and 0.05 < float(ref.mean()) < 0.95
    rows = torch.nonzero(seen).flatten()
    assert bool(seen[0]) and bool(seen[(rows[rows > 0] - 1) // 4].all())
    assert 1 < rows.numel() < seen.numel()


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
