"""Row bands in the port: ops/shard_utils on CPU ranks (gloo) against the
JAX package's under shard_map on a 2- and a 4-device mesh (conftest.py
gives 8 CPU devices), and the band raster (K1 and K5 take the band's first
tile row ``ty0``):

- extend_rows (halos 1, 8 and 32 over 4-row bands: the neighbour's whole
  band, then edge padding; zeros past the frame's top and bottom, as
  ppermute leaves them) and ext_row_index, equal;
- the band raster of stress:2 at 96x64 on 2 ranks: each band's depth,
  visid and attribute planes equal the port's whole-frame rows bit for bit;
- the port's band raster against the JAX banded rasterize (the Pallas
  kernel in interpret mode): depth within 1e-4, visid mismatches < 1%
  (tests/test_torch_raster.py's tolerances);
- K1's and K5's plain versions with ty0 on the JAX kernels' captured band
  inputs against the Pallas kernels' outputs, at the same tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from hobbyrenderer_tpu.ops import culling as jcull
from hobbyrenderer_tpu.ops import raster as jras
from hobbyrenderer_tpu.ops import raster_pallas as jrp
from hobbyrenderer_tpu.ops import shard_utils as jshu
from hobbyrenderer_tpu.parallel import build_mesh as jax_build_mesh
from hobbyrenderer_tpu.scene import make_stress_scene
from hobbyrenderer_tpu.scene.camera import Camera
from hobbyrenderer_tpu.scene.gpu import build_scene_gpu as jax_build_scene_gpu
from hobbyrenderer_tpu_torch.ops import raster as tras
from hobbyrenderer_tpu_torch.ops import raster_kernel as trk
from hobbyrenderer_tpu_torch.parallel.launch import run_ranks
from hobbyrenderer_tpu_torch.renderer import device_view_constants
from hobbyrenderer_tpu_torch.scene.gpu import build_scene_gpu as torch_build_scene_gpu
from tests import torch_parallel_ranks as tpr
from tests.torch_parity import same_mesh_cooker

try:
    shard_map = jax.shard_map
except AttributeError:      # older JAX
    from jax.experimental.shard_map import shard_map

HALOS = (1, 8, 32)
W, H = 96, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _same_mesh_cooker():
    same_mesh_cooker()


@pytest.mark.parametrize("n", (2, 4))
def test_extend_rows_matches_jax(n):
    h = 4
    full = np.random.default_rng(n).random((n * h, 3, 2)).astype(np.float32)
    gy = np.arange(-40, n * h + 40, dtype=np.int32)
    got = run_ranks(tpr.extend_body, n, args=(full, HALOS, gy), deadline_s=120)
    mesh = jax_build_mesh(n)
    for k, halo in enumerate(HALOS):
        def body(x, halo=halo):
            sh = jshu.make_row_shard("tiles", n, h)
            return jshu.extend_rows(x, halo, sh), jshu.ext_row_index(jnp.asarray(gy), halo, sh, h)
        ext, idx = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("tiles"),),
                                     out_specs=(P("tiles"), P("tiles")),
                                     check_vma=False))(jnp.asarray(full))
        ext = np.array(ext).reshape(n, h + 2 * halo, 3, 2)
        idx = np.asarray(idx).reshape(n, -1)
        for r in range(n):
            np.testing.assert_array_equal(got[r]["ext"][k], ext[r], err_msg=f"halo {halo}")
            np.testing.assert_array_equal(got[r]["idx"][k], idx[r], err_msg=f"halo {halo}")


@pytest.fixture(scope="module")
def stress2():
    """stress:2 at 96x64 (the JAX package's scene and its camera, without
    jitter), the JAX culling's slots, and the port's scene buffers."""
    scene = make_stress_scene(grid=2)
    cam = Camera(scene.cameras[0], W, H)
    cam.jitter_enabled = False
    vc = cam.view_constants(0)
    jg = jax_build_scene_gpu(scene)
    cull = jcull.cull_pairs(jg, vc, alpha_mask=jnp.asarray([True, True, False]))
    slots, _ = jcull.compact_mask(cull["mask"], int(jg.lod0_pair_capacity))
    return dict(vc=vc, jg=jg, slots=np.asarray(slots).astype(np.int64),
                tg=torch_build_scene_gpu(scene, "cpu"))


def test_band_raster_rows_equal_whole_frame(stress2):
    got = run_ranks(tpr.raster_body, 2, args=(stress2["vc"], W, H, stress2["slots"]),
                    deadline_s=120)
    vc = device_view_constants(stress2["vc"], "cpu")
    ro, attr = tras.rasterize(stress2["tg"], vc, torch.as_tensor(stress2["slots"]), W, H)
    assert (ro.visid >= 0).float().mean() > 0.5, "degenerate view"
    h = H // 2
    for r in range(2):
        assert got[r]["k1"]["ty0"] == r * h // 32
        np.testing.assert_array_equal(got[r]["depth"], ro.depth[r * h:(r + 1) * h].numpy())
        np.testing.assert_array_equal(got[r]["visid"], ro.visid[r * h:(r + 1) * h].numpy())
        np.testing.assert_array_equal(got[r]["attr"], attr[r * h:(r + 1) * h].numpy())


def _jax_band(monkeypatch, stress2, y0, depth_only=None):
    """JAX's banded rasterize through the Pallas kernels (interpret mode),
    capturing K1's call, or with ``depth_only`` set K5's."""
    seen = {}
    name = "raster_resolve_tiles" if depth_only is None else "raster_tiles"
    orig = getattr(jrp, name)

    def spy(records, work_tile, work_slot, **kw):
        out = orig(records, work_tile, work_slot, **kw)
        seen.update(records=torch.as_tensor(np.array(records)),
                    work_tile=torch.as_tensor(np.array(work_tile)),
                    work_slot=torch.as_tensor(np.array(work_slot)),
                    kw={k: kw[k] for k in ("tiles", "tx", "ty0")}, out=[np.array(o) for o in out])
        return out
    monkeypatch.setattr(jrp, name, spy)
    kw = dict(resolve_attrs=True) if depth_only is None else dict(depth_only=depth_only)
    out = jras.rasterize(stress2["jg"], stress2["vc"], jnp.asarray(stress2["slots"]), W, H,
                         y0=y0, shard_height=H // 2, backend="pallas", **kw)
    return seen, out


def _compare(d_a, v_a, d_b, v_b):
    np.testing.assert_allclose(d_a, d_b, atol=1e-4)
    mismatch = np.mean(v_a != v_b)
    assert mismatch < 0.01, mismatch
    return (v_a == v_b) & (v_a >= 0)


@pytest.mark.parametrize("y0", (0, 32))
def test_band_raster_matches_jax(monkeypatch, stress2, y0):
    seen, (jro, _aux, jattr) = _jax_band(monkeypatch, stress2, y0)
    assert int(seen["kw"]["ty0"]) == y0 // 32
    vc = device_view_constants(stress2["vc"], "cpu")
    ro, attr = tras.rasterize(stress2["tg"], vc, torch.as_tensor(stress2["slots"]), W, H,
                              y0=y0, shard_height=H // 2)
    agree = _compare(np.asarray(jro.depth), np.asarray(jro.visid), ro.depth.numpy(),
                     ro.visid.numpy())
    np.testing.assert_allclose(np.asarray(jattr)[agree], attr.numpy()[agree], atol=1e-4)
    assert agree.sum() > 200, "degenerate view"

    # K1's plain version with ty0 on the Pallas kernel's own inputs
    d, v, a = trk.raster_resolve_tiles(seen["records"], seen["work_tile"], seen["work_slot"],
                                       tiles=seen["kw"]["tiles"], tx=seen["kw"]["tx"],
                                       ty0=int(seen["kw"]["ty0"]))
    jd, jv, ja = seen["out"]
    agree = _compare(jd, jv, d.numpy(), v.numpy())
    np.testing.assert_allclose(np.moveaxis(ja, 1, 2)[agree], np.moveaxis(a.numpy(), 1, 2)[agree],
                               atol=1e-4)


@pytest.mark.parametrize("depth_only", (True, False), ids=("depth", "visid"))
def test_plain_k5_band_matches_pallas(monkeypatch, stress2, depth_only):
    seen, _ = _jax_band(monkeypatch, stress2, 32, depth_only=depth_only)
    rec = seen["records"]
    if rec.shape[-1] % 4:
        rec = torch.nn.functional.pad(rec, (0, 4 - rec.shape[-1] % 4))
    d, v = trk.raster_tiles(rec.contiguous(), seen["work_tile"], seen["work_slot"],
                            tiles=seen["kw"]["tiles"], tx=seen["kw"]["tx"],
                            ty0=int(seen["kw"]["ty0"]), depth_only=depth_only)
    jd, jv = seen["out"]
    _compare(jd, jv, d.numpy(), v.numpy())
    assert (jd > 0).mean() > 0.3
