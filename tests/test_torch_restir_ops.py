"""ReSTIR DI building blocks of the PyTorch port against the JAX package
on the CPU: the candidate kernel's plain version (K2) against the Pallas
kernel in interpret mode on one 8x128 block; the light pool, presample
tiles and polymorphic light evaluation; the reservoir helpers (tile-modal
mask, nearest warp, boiling filter); the denoiser (both profiles); the
port's own ReSTIR convergence test; and, on a GPU, the candidate kernel
against its plain version.

XLA:CPU contracts some products into fused multiply-adds while the port
rounds every product and sum, so sums of many terms (w_sum, the power CDF)
agree to a few ulp, not bit for bit; each test states its bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.ops import beam as jbeam
from hobbyrenderer_tpu.ops import denoise as jdn
from hobbyrenderer_tpu.ops import lights as jlights
from hobbyrenderer_tpu.ops import restir as jrestir
from hobbyrenderer_tpu.ops import restir_pallas as jrp
from hobbyrenderer_tpu.ops import warp as jwarp
from hobbyrenderer_tpu.ops.raster import GBuffer as JGBuffer
from hobbyrenderer_tpu.scene import make_stress_scene as jax_make_stress_scene
from hobbyrenderer_tpu.scene.gpu import build_scene_gpu as jax_build_scene_gpu
from hobbyrenderer_tpu_torch.config import RenderSettings
from hobbyrenderer_tpu_torch.ops import beam as tbeam
from hobbyrenderer_tpu_torch.ops import culling as tcull
from hobbyrenderer_tpu_torch.ops import denoise as tdn
from hobbyrenderer_tpu_torch.ops import lights as tlights
from hobbyrenderer_tpu_torch.ops import raster as traster
from hobbyrenderer_tpu_torch.ops import restir as trestir
from hobbyrenderer_tpu_torch.ops import restir_kernel as trk
from hobbyrenderer_tpu_torch.ops import shading as tshade
from hobbyrenderer_tpu_torch.ops import sky as tsky
from hobbyrenderer_tpu_torch.ops import warp as twarp
from hobbyrenderer_tpu_torch.scene.camera import Camera
from hobbyrenderer_tpu_torch.scene.cooker import cook_mesh
from hobbyrenderer_tpu_torch.scene.gpu import build_scene_gpu
from hobbyrenderer_tpu_torch.scene.procedural import (camera_looking_at, make_stress_scene,
                                                      plane_geometry)
from hobbyrenderer_tpu_torch.scene.scene import LIGHT_POINT, Light, Material, Node, Scene
from hobbyrenderer_tpu_torch.utils import math as hm
from tests.torch_parity import same_mesh_cooker


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


def _k2_inputs(seed=3, T=4, w_log=100):
    """One 8x128 block: a mix of directional, point, spot and emissive rows."""
    rng = np.random.default_rng(seed)
    S = trk.SEG
    kind = rng.integers(0, 4, (T, S))                       # 0 dir 1 point 2 spot 3 em
    rows = np.zeros((T, S, 18), np.float32)
    rows[..., 0] = np.where(kind == 3, 0, kind)
    rows[..., 1:4] = rng.uniform(-3, 3, (T, S, 3))
    dirs = rng.normal(size=(T, S, 3))
    rows[..., 4:7] = np.where((kind == 3)[..., None], rng.uniform(-0.5, 0.5, (T, S, 3)),
                              dirs / np.linalg.norm(dirs, axis=-1, keepdims=True))
    rows[..., 7:10] = np.where((kind == 3)[..., None], rng.uniform(-0.5, 0.5, (T, S, 3)),
                               rng.uniform(0, 20, (T, S, 3)))
    rows[..., 10] = rng.uniform(2, 30, (T, S))
    rows[..., 11] = np.where(kind == 3, rng.uniform(0, 4, (T, S)), 0.95)
    rows[..., 12] = np.where(kind == 3, rng.uniform(0, 4, (T, S)), 0.8)
    rows[..., 13] = kind == 3
    rows[..., 16] = rng.uniform(1, 50, (T, S))
    rows[..., 17] = np.where(rng.random((T, S)) < 0.05, -1, rng.integers(0, 300, (T, S)))
    flat3 = np.ascontiguousarray(rows.transpose(0, 2, 1))
    tsel = rng.integers(0, T, (trk.ROWS, 1)).astype(np.int32)
    n = rng.normal(size=(trk.ROWS, S, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    planes = np.concatenate([
        rng.uniform(-2, 2, (3, trk.ROWS, S)), n.transpose(2, 0, 1),
        rng.uniform(0, 1, (3, trk.ROWS, S)), rng.uniform(0, 1, (1, trk.ROWS, S)),
        np.where(rng.random((1, trk.ROWS, S)) < 0.5, 0.0, rng.uniform(0, 1, (1, trk.ROWS, S))),
        (rng.random((1, trk.ROWS, S)) < 0.9)], 0).astype(np.float32)
    cam = np.asarray([0.5, 4.0, 6.0], np.float32)
    return flat3, tsel, planes, cam, w_log


def test_plain_k2_matches_pallas_kernel():
    flat3, tsel, planes, cam, w_log = _k2_inputs()
    want = jrp.restir_candidates(jnp.asarray(flat3), jnp.asarray(tsel),
                                 [jnp.asarray(p) for p in planes], jnp.asarray(cam), 5, 0,
                                 num_candidates=8, w_log=w_log, interpret=True)
    yj, uj, vj, wj, rowj = (np.asarray(a) for a in want)
    got = trk.restir_candidates(torch.as_tensor(flat3), torch.as_tensor(tsel),
                                torch.as_tensor(planes), torch.as_tensor(cam), 5, 0,
                                num_candidates=8, w_log=w_log)
    yt, ut, vt, wt, rowt = (a.numpy() for a in got)
    assert np.mean(yj >= 0) > 0.5, "degenerate case"
    assert np.mean(yt == yj) >= 0.999, np.mean(yt == yj)
    same = yt == yj
    np.testing.assert_array_equal(ut[same], uj[same])
    np.testing.assert_array_equal(vt[same], vj[same])
    np.testing.assert_array_equal(rowt.transpose(0, 2, 1)[same], rowj.transpose(0, 2, 1)[same])
    # XLA:CPU contracts some products of the p-hat into FMAs, the port rounds
    # each: w_sum agrees to 1e-5 on >= 99% of the pixels, 1e-4 on all
    rel = np.abs(wt[same] - wj[same]) / np.maximum(np.abs(wj[same]), 1e-30)
    assert np.mean(rel <= 1e-5) >= 0.99, np.mean(rel <= 1e-5)
    np.testing.assert_allclose(wt[same], wj[same], rtol=1e-4)


def test_light_pool_and_presample_match_jax():
    # stress:4 is the smallest stress grid with emissive instances
    scene, jscene = make_stress_scene(grid=4), jax_make_stress_scene(grid=4)
    ml = max(64, len(scene.lights) + 8)
    jg = jax_build_scene_gpu(jscene, max_lights=ml)
    jpool = jlights.build_light_pool(jscene, jg)
    pool = tlights.build_light_pool(scene, build_scene_gpu(scene, "cpu", max_lights=ml))
    assert pool.n_total > pool.n_analytic, "no emissive triangles in the pool"
    assert (pool.n_analytic, pool.n_total) == (int(jpool.n_analytic), int(jpool.n_total))
    for k in ("em_v0", "em_e1", "em_e2", "em_rad", "em_orig", "packed"):
        np.testing.assert_array_equal(getattr(pool, k).numpy(), np.asarray(getattr(jpool, k)),
                                      err_msg=k)
    for k in ("power_pdf", "power_cdf"):
        np.testing.assert_allclose(getattr(pool, k).numpy(), np.asarray(getattr(jpool, k)),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    want = np.asarray(jlights.presample_light_rows(jpool, jnp.uint32(7)))
    got = tlights.presample_light_rows(pool, 7).numpy()
    # the power CDF's sums round in another order than XLA's, so a draw that
    # lands within an ulp of a CDF step may pick the neighbouring light
    assert np.mean(got[..., 17] == want[..., 17]) > 0.99
    same = got[..., 17] == want[..., 17]
    np.testing.assert_allclose(got[same], want[same], rtol=1e-5)
    # the polymorphic evaluation of those rows at random points
    rng = np.random.default_rng(1)
    pos = rng.uniform(-5, 5, want.shape[:2] + (3,)).astype(np.float32)
    uv = rng.random(want.shape[:2] + (2,)).astype(np.float32)
    Lj, rj, dj = (np.asarray(a) for a in jlights.light_incident_rows(
        jnp.asarray(want[..., :16]), jnp.asarray(uv), jnp.asarray(pos)))
    Lt, rt_, dt = (a.numpy() for a in tlights.light_incident_rows(
        torch.as_tensor(want[..., :16]), torch.as_tensor(uv), torch.as_tensor(pos)))
    np.testing.assert_allclose(Lt, Lj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rt_, rj, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(dt, dj, rtol=1e-5)


def test_reservoir_helpers_match_jax():
    rng = np.random.default_rng(2)
    h, w = 70, 100                                   # partial 32x32 tiles
    key = rng.integers(0, 4, (h, w)).astype(np.int32)
    key[:, :40] = 2
    key[rng.random((h, w)) < 0.2] = -1
    want = np.asarray(jbeam.tile_majority_mask(jnp.asarray(key), h, w, exclude=-1))
    got = tbeam.tile_majority_mask(torch.as_tensor(key.astype(np.int64)), h, w, exclude=-1)
    np.testing.assert_array_equal(got.numpy(), want)
    img = rng.normal(size=(h, w, 5)).astype(np.float32)
    img[..., 0] = rng.integers(-1, 40, (h, w))
    motion = (rng.normal(size=(h, w, 2)) * 2.0 + [3.3, -1.6]).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b: jwarp.warp_image(a, b, halo=32, bilinear=False))(
        jnp.asarray(img), jnp.asarray(motion)))
    got = twarp.warp_image(torch.as_tensor(img), torch.as_tensor(motion), halo=32,
                           bilinear=False).numpy()
    np.testing.assert_array_equal(got, want)
    ws = rng.exponential(size=(h, w)).astype(np.float32)
    ws[rng.random((h, w)) < 0.01] *= 200.0
    live = rng.random((h, w)) < 0.8
    want = np.asarray(jax.jit(jrestir.boiling_filter_mask)(jnp.asarray(ws), jnp.asarray(live)))
    got = trestir.boiling_filter_mask(torch.as_tensor(ws), torch.as_tensor(live)).numpy()
    assert want.sum() > 10
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("profile", ["relax", "reblur"])
def test_denoise_matches_jax(profile):
    rng = np.random.default_rng(4)
    h, w = 40, 56
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    fields = dict(albedo=rng.random((h, w, 3)), normal=n, geo_normal=n,
                  orm=rng.random((h, w, 3)), emissive=np.zeros((h, w, 3)),
                  # whole-pixel motion: the warp moves texels exactly, so the
                  # history validation tests compare exact values
                  motion=np.broadcast_to(np.where(np.arange(w)[None, :, None] < 20,
                                                  [2.0, -1.0], [-1.0, 0.0]), (h, w, 2)),
                  world_pos=rng.random((h, w, 3)),
                  depth=rng.uniform(0.1, 1.0, (h, w)), material=np.zeros((h, w), np.int32),
                  valid=rng.random((h, w)) < 0.9)
    fields = {k: (v.astype(np.float32) if v.dtype == np.float64 else v)
              for k, v in fields.items()}
    sig = rng.exponential(size=(h, w, 3)).astype(np.float32)
    st = [rng.random((h, w, 3)), rng.random((h, w, 2)), rng.integers(0, 5, (h, w)),
          rng.uniform(0.1, 1.0, (h, w)), n]
    st = [np.asarray(a, np.float32) for a in st]
    out_j, st_j = jax.jit(lambda *a: jdn.denoise(*a, profile=profile))(
        jnp.asarray(sig), JGBuffer(**{k: jnp.asarray(v) for k, v in fields.items()}),
        jdn.DenoiseState(*[jnp.asarray(a) for a in st]))
    out_t, st_t = tdn.denoise(torch.as_tensor(sig),
                              traster.GBuffer(**{k: torch.as_tensor(v)
                                                 for k, v in fields.items()}),
                              tdn.DenoiseState(*[torch.as_tensor(a) for a in st]),
                              profile=profile)
    # XLA fuses the jitted chain into FMAs and the normal weight pow(., 64)
    # multiplies that rounding difference 64-fold: a few outputs differ ~1e-3
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-3, atol=1e-5)
    for a, b in zip(st_t, st_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_k2_matches_plain(cuda_device):
    flat3, tsel, planes, cam, w_log = _k2_inputs(seed=8, T=6)
    planes = np.tile(planes, (1, 4, 3))                 # (12, 32, 384): 12 blocks
    tsel = np.tile(tsel, (4, 3))
    args = [torch.as_tensor(a).to(cuda_device) for a in (flat3, tsel, planes, cam)]
    n0 = trk.launches
    got = trk.restir_candidates(*args, 9, 0, num_candidates=8, w_log=w_log)
    torch.cuda.synchronize()
    assert trk.launches == n0 + 1
    ref = trk.restir_candidates_reference(*args, 9, 0, num_candidates=8, w_log=w_log)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_restir_converges_to_bruteforce():
    """The port's own version of tests/test_restir.py::
    test_restir_converges_to_bruteforce: 12 point lights over a plane,
    48 frames of restir_di (analytic-only pool, no visibility) average to
    the unshadowed sum over all lights."""
    w, h = 48, 32
    sc = Scene()
    m = sc.add_material(Material(name="grey", base_color=np.array([0.7, 0.7, 0.7, 1], np.float32),
                                 roughness=0.7))
    pos, nrm, uv, idx = plane_geometry(6.0)
    sc.add_node(Node(name="p", mesh_primitives=[
        sc.add_mesh(cook_mesh(pos, idx, normals=nrm, uvs=uv), material=m)]))
    rng = np.random.default_rng(5)
    for _ in range(12):
        sc.add_light(Light(type=LIGHT_POINT,
                           position=np.array([rng.uniform(-4, 4), rng.uniform(1, 3),
                                              rng.uniform(-4, 4)], np.float32),
                           color=rng.uniform(0.2, 1.0, 3).astype(np.float32),
                           intensity=float(rng.uniform(5, 30)), range=50.0))
    sc.cameras.append(camera_looking_at(np.array([0, 4, 6], np.float32), np.zeros(3)))
    sc.finalize()
    gpu = build_scene_gpu(sc, "cpu")
    cam = Camera(sc.cameras[0], w, h)
    cam.jitter_enabled = False
    vc = {}
    for k, v in cam.view_constants(0).items():
        a = np.asarray(v)
        vc[k] = ((int(a) if a.dtype.kind in "iu" else float(a)) if a.ndim == 0 else
                 (float(a[0]), float(a[1])) if k == "viewport" else
                 torch.as_tensor(a.astype(np.float32)))
    vc["frustum_planes"] = torch.as_tensor(
        hm.extract_frustum_planes(np.asarray(vc["view_proj"].numpy(), np.float32)))
    cull = tcull.cull_pairs(gpu, vc, alpha_mask=(True, True, False))
    slots, _ = tcull.compact_mask(cull["mask"], max(int(gpu.lod0_pair_capacity), 1))
    ro, attr = traster.rasterize(gpu, vc, slots, w, h)
    gb = traster.resolve_gbuffer(gpu, vc, ro, attr)

    v = -tsky.view_dirs_from_pixels(vc, h, w)
    ref = tshade.shade_all_lights(gpu, gb.world_pos, gb.normal, v, gb.albedo,
                                  gb.orm[..., 2], gb.orm[..., 1])
    ref = torch.where(gb.valid[..., None], ref, 0.0).numpy()
    res = trestir.reservoir_init(h, w, "cpu")
    settings = RenderSettings()
    acc = np.zeros((h, w, 3), np.float32)
    n_frames = 48
    for i in range(n_frames):
        direct, res = trestir.restir_di(gpu, None, gb, vc, settings, res, i, visibility=False)
        acc += direct.numpy()
    avg = acc / n_frames
    valid = gb.valid.numpy()
    lit = valid & (ref.sum(-1) > 1e-3)
    assert lit.mean() > 0.3, "degenerate case"
    rel = np.abs(avg[lit] - ref[lit]).sum() / (ref[lit].sum() + 1e-9)
    assert rel < 0.15, f"ReSTIR mean deviates {rel:.3f} from brute force"
    per_px = np.abs(avg - ref).sum(-1) / np.maximum(ref.sum(-1), 1e-3)
    assert np.median(per_px[lit]) < 0.2
