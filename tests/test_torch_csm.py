"""The cascaded-shadow path of the PyTorch port against the JAX package on
the CPU: the depth-only tile raster's plain version (K5) against the Pallas
kernel in interpret mode, on the records and worklist of a 4-cascade atlas
at res 128 (64 tiles) of stress:2; the port's atlas raster against the JAX
one (XLA branch); the cascade matrices and their caster culling; the PCF
shadow mask and the screen-space contact shadows from one G-buffer; and, on
a GPU, the K5 kernel against its plain version.

The JAX atlas on the CPU takes its XLA segment-max branch, whose planes are
evaluated at global pixel coordinates; K5 and the port re-centre them on the
tile origin, so atlas depths agree to rounding (atol 1e-4, the JAX
package's own bound in tests/test_raster_pallas.py)."""

import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.ops import csm as jcsm
from hobbyrenderer_tpu.ops import raster as jraster
from hobbyrenderer_tpu.ops import raster_pallas as jrp
from hobbyrenderer_tpu.ops import sss as jsss
from hobbyrenderer_tpu.ops.raster import GBuffer as JGBuffer
from hobbyrenderer_tpu.scene import make_stress_scene
from hobbyrenderer_tpu.scene.camera import Camera
from hobbyrenderer_tpu.scene.gpu import build_scene_gpu as jax_build_scene_gpu
from hobbyrenderer_tpu_torch.ops import csm as tcsm
from hobbyrenderer_tpu_torch.ops import culling as tcull
from hobbyrenderer_tpu_torch.ops import raster as traster
from hobbyrenderer_tpu_torch.ops import raster_kernel as trk
from hobbyrenderer_tpu_torch.ops import sss as tsss
from hobbyrenderer_tpu_torch.scene.gpu import scene_gpu_from_numpy
from hobbyrenderer_tpu_torch.utils import math as hm
from tests.torch_parity import same_mesh_cooker

W, H = 96, 64
ATLAS_RES = 128


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


def port_vc(vc, device="cpu"):
    """A JAX view-constant dict (numpy) -> the port's (Renderer.view_constants)."""
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


_CACHE = {}


def _setup():
    """stress:2 in both packages, the scene's camera, the sun, and the JAX
    render_cascades' light matrices and caster slots (its atlas raster is
    replaced by a stub that records them)."""
    if _CACHE:
        return _CACHE
    scene = make_stress_scene(grid=2)
    jg = jax_build_scene_gpu(scene)
    leaves = {k: np.asarray(getattr(jg, k)) for k in jg.__dataclass_fields__
              if getattr(jg, k) is not None}
    tg = scene_gpu_from_numpy(leaves, "cpu")
    vc = Camera(scene.cameras[0], W, H).view_constants(0)     # the Renderer's view
    sun = np.asarray(leaves["light_dir"][tg.meta["sun_index"]], np.float32)
    assert tg.meta["has_sun"]
    seen = {}
    orig = jraster.rasterize_shadow_atlas

    def stub(gpu, vps, slots, res, **kw):
        seen.update(vps=np.array(vps), slots=np.array(slots))
        return np.zeros((vps.shape[0], res, res), np.float32)

    jraster.rasterize_shadow_atlas = stub
    try:
        dist = float(min(max(2.0 * tg.meta["scene_radius"], 20.0), 400.0))
        jcsm.render_cascades(jg, vc, sun, tg.shadow_pair_capacity(jcsm.CASCADE_LOD_BIAS),
                             max_distance=dist)
    finally:
        jraster.rasterize_shadow_atlas = orig
    _CACHE.update(jg=jg, tg=tg, vc=vc, tvc=port_vc(vc), sun=sun, dist=dist, **seen)
    return _CACHE


def _pallas_inputs():
    """Records and worklist of the JAX atlas's kernel branch at ATLAS_RES."""
    s = _setup()
    if "k5" in s:
        return s["k5"]
    orig = jrp.raster_tiles
    got = {}

    def spy(records, work_tile, work_slot, **kw):
        got.update(records=np.array(records), work_tile=np.array(work_tile),
                   work_slot=np.array(work_slot), tiles=kw["tiles"], tx=kw["tx"])
        return orig(records, work_tile, work_slot, **kw)

    jrp.raster_tiles = spy
    try:
        depth = jraster.rasterize_shadow_atlas(s["jg"], s["vps"], s["slots"], ATLAS_RES,
                                               backend="pallas")
    finally:
        jrp.raster_tiles = orig
    got["depth"] = np.asarray(depth)
    s["k5"] = got
    return got


@pytest.mark.parametrize("depth_only", [True, False], ids=["depth_only", "depth_visid"])
def test_plain_k5_matches_pallas_kernel(depth_only):
    k = _pallas_inputs()
    n_items = int((k["work_tile"] < k["tiles"]).sum())
    assert k["tiles"] == 64 and n_items > 64, (k["tiles"], n_items)
    dj, vj = jrp.raster_tiles(k["records"], k["work_tile"], k["work_slot"], tiles=k["tiles"],
                              tx=k["tx"], depth_only=depth_only, interpret=True)
    dj, vj = np.asarray(dj), np.asarray(vj)
    dt, vt = trk.raster_tiles(torch.as_tensor(k["records"]), torch.as_tensor(k["work_tile"]),
                              torch.as_tensor(k["work_slot"]), tiles=k["tiles"], tx=k["tx"],
                              depth_only=depth_only)
    dt, vt = dt.numpy(), vt.numpy()
    assert np.mean(dj > 0) > 0.02, "degenerate atlas"
    # XLA:CPU may contract the plane products into FMAs: a few ulp (measured
    # 9.5e-7 on 348 of 65,536 texels)
    assert np.abs(dt - dj).max() <= 1e-5, np.abs(dt - dj).max()
    if depth_only:
        assert (vt == -1).all() and (vj == -1).all()
    else:
        assert np.mean(vt == vj) >= 0.999, np.mean(vt == vj)     # measured: all


def test_shadow_atlas_matches_jax():
    s = _setup()
    want = np.asarray(jraster.rasterize_shadow_atlas(s["jg"], s["vps"], s["slots"], ATLAS_RES,
                                                     backend="xla"))
    got = traster.rasterize_shadow_atlas(s["tg"], torch.as_tensor(s["vps"]),
                                         torch.as_tensor(s["slots"]).long(), ATLAS_RES).numpy()
    assert got.shape == (4, ATLAS_RES, ATLAS_RES)
    assert np.mean(want > 0) > 0.02, "degenerate atlas"
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, _pallas_inputs()["depth"], atol=1e-5)


def test_cascades_match_jax():
    """Light matrices and splits (atol 1e-5) and the (cascade, pair) caster
    slots of render_cascades, equal."""
    s = _setup()
    vps_j, splits_j = jcsm.cascade_matrices(s["vc"], s["sun"], s["dist"])
    vps_t, splits_t = tcsm.cascade_matrices(s["tvc"], torch.as_tensor(s["sun"]), s["dist"])
    np.testing.assert_allclose(vps_t.numpy(), np.asarray(vps_j), atol=1e-5)
    np.testing.assert_allclose(splits_t.numpy(), np.asarray(splits_j), rtol=1e-6)
    seen = {}
    orig = traster.rasterize_shadow_atlas

    def stub(gpu, vps, slots, res):
        seen["slots"] = slots
        return torch.zeros((vps.shape[0], res, res))

    traster.rasterize_shadow_atlas = stub
    try:
        tcsm.render_cascades(s["tg"], s["tvc"], torch.as_tensor(s["sun"]),
                             s["tg"].shadow_pair_capacity(tcsm.CASCADE_LOD_BIAS), s["dist"])
    finally:
        traster.rasterize_shadow_atlas = orig
    np.testing.assert_array_equal(seen["slots"].numpy(), s["slots"])
    assert (s["slots"] >= 0).sum() > 10


def _gbuffer_and_csm():
    """A G-buffer (the port's CPU raster of the default view) and the
    port's 4-cascade CSM data, both as numpy."""
    s = _setup()
    if "gb" in s:
        return s["gb"], s["csm"]
    tg, tvc = s["tg"], s["tvc"]
    cull = tcull.cull_pairs(tg, tvc, alpha_mask=(True, True, False))
    slots, _ = tcull.compact_mask(cull["mask"], tg.lod0_pair_capacity)
    ro, attr = traster.rasterize(tg, tvc, slots, W, H)
    gb = traster.resolve_gbuffer(tg, tvc, ro, attr)
    data = tcsm.render_cascades(tg, tvc, torch.as_tensor(s["sun"]),
                                tg.shadow_pair_capacity(tcsm.CASCADE_LOD_BIAS), s["dist"])
    s["gb"] = {k: v.numpy() for k, v in gb._asdict().items()}
    s["csm"] = {k: v.numpy() for k, v in data._asdict().items()}
    return s["gb"], s["csm"]


@pytest.mark.parametrize("which", ["csm_mask", "contact"])
def test_shadow_masks_match_jax(which):
    """The PCF mask (half res, as the ShadowCSM pass samples it) and the
    contact shadows from the same inputs: >= 99.5% of the pixels equal
    (measured: all, with about half of them shadowed)."""
    s = _setup()
    gb, data = _gbuffer_and_csm()
    assert gb["valid"].mean() > 0.3, "degenerate view"
    sun_t = torch.as_tensor(s["sun"])
    if which == "csm_mask":
        sub = {k: gb[k][::2, ::2] for k in ("world_pos", "geo_normal", "valid")}
        want = jcsm.csm_shadow_mask(jcsm.CSMData(**data), s["vc"], sub["world_pos"],
                                    sub["geo_normal"], sub["valid"], s["sun"])
        got = tcsm.csm_shadow_mask(tcsm.CSMData(**{k: torch.as_tensor(v)
                                                   for k, v in data.items()}),
                                   s["tvc"], *(torch.as_tensor(sub[k]) for k in
                                               ("world_pos", "geo_normal", "valid")), sun_t)
    else:
        want = jsss.screen_space_shadows(JGBuffer(**gb), s["vc"], s["sun"])
        got = tsss.screen_space_shadows(
            traster.GBuffer(**{k: torch.as_tensor(v) for k, v in gb.items()}), s["tvc"], sun_t)
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape
    assert np.mean(want < 1.0) > 0.01, "no shadow in view"
    same = np.mean(np.abs(got - want) <= 1e-6)
    assert same >= 0.995, same


def _tri_rows(kind, rng, m=48):
    """m items of 32 triangle rows (m, 32, 9) as ops/raster.py builds them
    from screen vertices, and their tiles' origins (m, 1, 1) anywhere in a
    4096 x 4096 atlas. ``kind``: random triangles about the tile; slivers
    (a vertex within 1e-3 px of the opposite edge); triangles whose edges
    run through pixel centres (vertices on the centres' grid); and invalid
    rows (ok flag off, l1c = -1e9)."""
    ox = rng.integers(0, 128, m) * 32 + 0.5
    oy = rng.integers(0, 128, m) * 32 + 0.5
    o = np.stack([ox, oy], -1)[:, None, None, :]
    size = rng.choice([0.7, 3.0, 12.0, 40.0], (m, 32, 1, 1))
    v = o + 15.5 + rng.normal(size=(m, 32, 3, 2)) * size
    if kind == "slivers":
        t = rng.uniform(-0.2, 1.2, (m, 32, 1))
        v[..., 2, :] = (v[..., 0, :] * (1 - t) + v[..., 1, :] * t
                        + rng.uniform(-1e-3, 1e-3, (m, 32, 2)))
    elif kind == "centre_edges":
        v = o + rng.integers(-8, 40, (m, 32, 3, 2)).astype(np.float64)
    tv = torch.as_tensor(v.astype(np.float32))
    tz = torch.as_tensor(rng.uniform(0.01, 1.0, (m, 32, 3)).astype(np.float32))
    e1, e2 = tv[..., 1, :] - tv[..., 0, :], tv[..., 2, :] - tv[..., 0, :]
    area2 = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]
    nondegen = torch.abs(area2) > 1e-12
    tok = nondegen & torch.tensor(kind != "invalid")
    coeff = traster._tri_affine_coeffs(tv, tz, torch.where(nondegen, 1.0 / area2, 0.0), tok)
    rows = trk._raster_body(coeff)
    return (rows, torch.as_tensor(ox, dtype=torch.float32)[:, None, None],
            torch.as_tensor(oy, dtype=torch.float32)[:, None, None])


def _strips_inside(rows, oxf, oyf):
    """(m, 32 rows, 32 strips): some pixel of the strip is inside the row by
    the kernels' f32 arithmetic (_plane_eval, the same rounding)."""
    p = torch.arange(trk.PIX)
    xl, yl = (p % 32).to(torch.float32)[None, :], (p // 32).to(torch.float32)[None, :]
    l1 = trk._plane_eval(rows, oxf, oyf, xl, yl, 0)
    l2 = trk._plane_eval(rows, oxf, oyf, xl, yl, 3)
    inside = (l1 >= 0.0) & (l2 >= 0.0) & (l1 + l2 <= 1.0)
    return inside.reshape(*inside.shape[:2], 32, 32).any(-1)


@pytest.mark.parametrize("kind", ["random", "slivers", "centre_edges", "invalid", "atlas"])
def test_strip_cull_keeps_every_inside_row(kind):
    """The strip test (_rows_outside_strips, the kernels' per warp cull)
    never drops a row that the f32 evaluation finds inside some pixel of
    the strip: random and adversarial triangles, and the atlas's rows."""
    if kind == "atlas":
        k = _pallas_inputs()
        n = int((k["work_tile"] < k["tiles"]).sum())
        t = torch.as_tensor(k["work_tile"][:n]).long()
        rows = torch.as_tensor(k["records"])[torch.as_tensor(k["work_slot"][:n]).long()][..., :9]
        oxf = ((t % k["tx"]) * 32).to(torch.float32)[:, None, None] + 0.5
        oyf = ((t // k["tx"]) * 32).to(torch.float32)[:, None, None] + 0.5
    else:
        rows, oxf, oyf = _tri_rows(kind, np.random.default_rng(len(kind)))
    out = trk._rows_outside_strips(rows, oxf, oyf)
    inside = _strips_inside(rows, oxf, oyf)
    assert out.shape == inside.shape == (rows.shape[0], 32, 32)
    assert not bool((out & inside).any()), int((out & inside).sum())
    if kind == "invalid":
        assert bool(out.all())
    else:       # the test culls, and the inside rows are not all of the kept ones
        assert bool(inside.any()) and 0.2 < float(out.float().mean()) < 1.0
        assert float(inside.float().mean()) > 0.0


@pytest.mark.cuda
def test_cuda_k5_matches_plain(cuda_device):
    k = _pallas_inputs()
    rec = torch.as_tensor(k["records"][..., :trk.REC_LANES_DEPTH].copy())
    args = [t.to(cuda_device) for t in (rec, torch.as_tensor(k["work_tile"]),
                                        torch.as_tensor(k["work_slot"]))]
    for depth_only in (True, False):
        got = trk.raster_tiles(*args, tiles=k["tiles"], tx=k["tx"], depth_only=depth_only)
        want = trk.raster_tiles_reference(*args, tiles=k["tiles"], tx=k["tx"],
                                          depth_only=depth_only)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
