"""Tile raster + fused resolve: the port's plain version of the kernel
against the JAX Pallas kernel (interpret mode on the CPU), the port's
record/worklist builders against the JAX ones, and — on a GPU — the CUDA
kernel against its plain version."""

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
from hobbyrenderer_tpu_torch.ops import raster as tras
from hobbyrenderer_tpu_torch.ops import raster_kernel as trk
from hobbyrenderer_tpu_torch.scene.gpu import build_scene_gpu as torch_build_scene_gpu

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


@pytest.mark.cuda
def test_cuda_k1_matches_plain(cuda_device, monkeypatch):
    w, h = 256, 192
    _scene, vc, jg, slots = _setup("stress:2", w, h)
    seen, _ro, _attr = _jax_kernel_run(monkeypatch, jg, vc, slots, w, h)
    args = [torch.as_tensor(seen[k]).to(cuda_device) for k in ("records", "work_tile", "work_slot")]
    kw = dict(tiles=seen["tiles"], tx=seen["tx"])
    n0 = trk.launches
    d, v, a = trk.raster_resolve_tiles(*args, **kw)
    torch.cuda.synchronize()
    assert trk.launches == n0 + 1
    rd, rv, ra = trk.raster_resolve_tiles_reference(*args, **kw)
    np.testing.assert_allclose(d.cpu().numpy(), rd.cpu().numpy(), atol=1e-5)
    assert np.mean(v.cpu().numpy() != rv.cpu().numpy()) < 1e-3
    agree = (v == rv)[:, None, :].expand_as(a)
    np.testing.assert_allclose(a[agree].cpu().numpy(), ra[agree].cpu().numpy(), atol=1e-4)
