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
from hobbyrenderer_tpu_torch.utils.rng import pcg3d
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


def _k2_kernel_order(flat3, tsel, planes, cam, frame, y0, n_cand, w_log):
    """csrc/restir_candidates.cu's order of work in plain PyTorch: the 7
    terms that depend on the light slot alone (the emissive triangle's
    normal, 1/|n|, area, max(range, 1e-4), the spot denominator) computed
    once a tile slot, then each candidate evaluates only its slot's kind of
    light before the GGX p-hat and the streaming RIS update."""
    rsq = trk._rsqrt
    c = flat3.permute(1, 0, 2)                                  # (18, T, 128)
    cxn = c[5] * c[9] - c[6] * c[8]
    cyn = c[6] * c[7] - c[4] * c[9]
    czn = c[8] * c[4] - c[5] * c[7]
    n2 = cxn * cxn + cyn * cyn + czn * czn
    inv_n = rsq(torch.clamp(n2, min=1e-24))
    slot = torch.stack([cxn, cyn, czn, inv_n, 0.5 * n2 * inv_n, torch.clamp(c[10], min=1e-4),
                        torch.clamp(c[11] - c[12], min=1e-4)], 1)     # (T, 7, 128)
    ext = torch.cat([flat3, slot], 1)
    _, Hp, Wp = planes.shape
    tiles = ext[torch.clamp(tsel.to(torch.int64), 0, flat3.shape[0] - 1)]   # (Hp, nseg, 25, 128)
    px, py, pz, nx, ny, nz, ar, ag, ab, rg, metal, va = planes
    rough = torch.clamp(rg, 0.03, 1.0)
    tvx, tvy, tvz = cam[0] - px, cam[1] - py, cam[2] - pz
    vn = rsq(torch.clamp(tvx * tvx + tvy * tvy + tvz * tvz, min=1e-12))
    vx, vy, vz = tvx * vn, tvy * vn, tvz * vn
    ndv = torch.clamp(nx * vx + ny * vy + nz * vz, min=1e-5)
    a2 = (rough * rough) * (rough * rough)
    inv_m = 1.0 - metal
    dif = (ar * inv_m, ag * inv_m, ab * inv_m)
    f0 = tuple(0.04 * inv_m + a * metal for a in (ar, ag, ab))
    smith_v = torch.sqrt(torch.clamp(ndv * ndv * (1 - a2) + a2, min=1e-8))
    gy = torch.arange(Hp, dtype=torch.int64)[:, None] + y0
    pix = (gy * w_log + torch.arange(Wp, dtype=torch.int64)[None, :]).expand(Hp, Wp)
    ry, ru, rv = torch.full((Hp, Wp), -1.0), torch.zeros((Hp, Wp)), torch.zeros((Hp, Wp))
    w_sum, rrow = torch.zeros((Hp, Wp)), torch.zeros((16, Hp, Wp))
    for k in range(n_cand):
        ch = torch.roll(tiles, -((17 * k) % 128), dims=-1).permute(2, 0, 1, 3).reshape(25, Hp, Wp)
        bits = pcg3d(torch.stack([pix, torch.full_like(pix, frame),
                                  torch.full_like(pix, 100 + k)], -1))
        u_r, u_u, u_v = (trk._u01(bits[..., i]) for i in range(3))
        em = ch[13] > 0.5
        L, rad = torch.zeros((3, Hp, Wp)), torch.zeros((3, Hp, Wp))
        e, a_ = em, ~em
        # emissive slots: a point on the triangle, the per-slot normal and area
        over = (u_u + u_v)[e] > 1.0
        uu = torch.where(over, 1.0 - u_u[e], u_u[e])
        vv = torch.where(over, 1.0 - u_v[e], u_v[e])
        pl = [ch[1 + i][e] + uu * ch[4 + i][e] + vv * ch[7 + i][e] - q[e]
              for i, q in enumerate((px, py, pz))]
        d2e = torch.clamp(pl[0] * pl[0] + pl[1] * pl[1] + pl[2] * pl[2], min=1e-8)
        inv_de = rsq(d2e)
        le = [x * inv_de for x in pl]
        cos_l = torch.abs((ch[18][e] * le[0] + ch[19][e] * le[1] + ch[20][e] * le[2]) * ch[21][e])
        ge = cos_l * ch[22][e] / d2e
        for i in range(3):
            L[i][e] = le[i]
            rad[i][e] = ch[10 + i][e] * ge
        # analytic slots: directional, point or spot
        is_dir = ch[0][a_] < 0.5
        is_spot = ch[0][a_] > 1.5
        tl = [torch.where(is_dir, -ch[4 + i][a_], ch[1 + i][a_] - q[a_])
              for i, q in enumerate((px, py, pz))]
        d2a = torch.clamp(tl[0] * tl[0] + tl[1] * tl[1] + tl[2] * tl[2], min=1e-16)
        inv_da = rsq(d2a)
        la = [x * inv_da for x in tl]
        xr = torch.clamp((d2a * inv_da) / ch[23][a_], 0.0, 1.0)
        fall = 1.0 - xr * xr * xr * xr
        fall = torch.clamp(fall * fall, 0.0, 1.0)
        atten = torch.where(is_dir, 1.0, fall / torch.clamp(d2a, min=1e-4))
        cd = -(la[0] * ch[4][a_] + la[1] * ch[5][a_] + la[2] * ch[6][a_])
        spot = torch.clamp((cd - ch[12][a_]) / ch[24][a_], 0.0, 1.0)
        atten = torch.where(is_spot, atten * spot * spot, atten)
        for i in range(3):
            L[i][a_] = la[i]
            rad[i][a_] = ch[7 + i][a_] * atten
        hx, hy, hz = vx + L[0], vy + L[1], vz + L[2]
        hn = rsq(torch.clamp(hx * hx + hy * hy + hz * hz, min=1e-12))
        hx, hy, hz = hx * hn, hy * hn, hz * hn
        ndl = torch.clamp(nx * L[0] + ny * L[1] + nz * L[2], min=0.0)
        ndh = torch.clamp(nx * hx + ny * hy + nz * hz, min=0.0)
        vdh = torch.clamp(vx * hx + vy * hy + vz * hz, min=0.0)
        dterm = ndh * ndh * (a2 - 1.0) + 1.0
        D = a2 / torch.clamp(3.14159265 * dterm * dterm, min=1e-8)
        gl = ndv * torch.sqrt(torch.clamp(ndl * ndl * (1 - a2) + a2, min=1e-8))
        Vis = 0.5 / torch.clamp(ndl * smith_v + gl, min=1e-8)
        fr5 = torch.clamp(1.0 - vdh, 0.0, 1.0)
        fr5 = fr5 * fr5 * fr5 * fr5 * fr5
        DV = D * Vis
        shade = [((1.0 - (f + (1.0 - f) * fr5)) * dc * (1.0 / 3.14159265)
                  + DV * (f + (1.0 - f) * fr5)) * ndl * r_ for f, dc, r_ in zip(f0, dif, rad)]
        ph = 0.2126 * shade[0] + 0.7152 * shade[1] + 0.0722 * shade[2]
        ph = torch.where((va > 0.5) & (ch[17] >= 0.0), ph, 0.0)
        w_c = ph * ch[16]
        w_sum = w_sum + w_c
        take = (u_r * torch.clamp(w_sum, min=1e-20)) < w_c
        ry, ru, rv = torch.where(take, ch[17], ry), torch.where(take, u_u, ru), torch.where(take, u_v, rv)
        rrow = torch.where(take[None], ch[:16], rrow)
    return ry, ru, rv, w_sum, rrow.permute(1, 0, 2).contiguous()


@pytest.mark.parametrize("seed", [3, 11])
def test_k2_kernel_order_matches_plain(seed):
    """The kernel computes the per-slot terms once a slot and only the
    slot's kind of light; in plain PyTorch that order gives the plain
    version's bits in all five outputs (the kernel, built with -fmad=false,
    rounds each operation as both do)."""
    flat3, tsel, planes, cam, w_log = (torch.as_tensor(a) for a in _k2_inputs(seed=seed, T=6))
    ref = trk.restir_candidates_reference(flat3, tsel, planes, cam, 7, 16, 8, w_log)
    got = _k2_kernel_order(flat3, tsel, planes, cam, 7, 16, 8, w_log)
    assert float((ref[0] >= 0).float().mean()) > 0.5, "degenerate case"
    assert 0.1 < float((flat3[:, 13] > 0.5).float().mean()) < 0.9
    for name, a, b in zip(("y", "u", "v", "w_sum", "row"), got, ref):
        assert torch.equal(a, b), name


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
