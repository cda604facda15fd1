"""ReGIR in the PyTorch port (ops/regir.py and restir_di's regir_grid
branch) against the JAX package on the CPU: both cell builds on the JAX
frame's light pool, cells_of_positions in both layouts, and restir_di with
the onion grid on the JAX ReGIR frame's own G-buffer and reservoirs
(stress:2 at 96x64, 3 frames of the JAX Renderer with direct_mode="restir",
regir=True).

Gates: light ids of every cell slot equal; W within 1e-5 relative (measured
max 8.9e-7 onion, 5.0e-7 grid; the reference's XLA fuses some products into
FMAs); the cell ids of positions equal away from cell boundaries (lanes
within 1e-3 of a boundary in any coordinate are left out and counted, and
must stay under 2%);
restir_di as tests/test_torch_restir.py::test_restir_di_matches_jax gates
it: winners agree on > 98% of pixels, the denoised direct light within 2%
relative L1."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.config import Config as JaxConfig
from hobbyrenderer_tpu.graph.rendergraph import FrameContext
from hobbyrenderer_tpu.ops import regir as jregir
from hobbyrenderer_tpu.renderer import Renderer as JaxRenderer
from hobbyrenderer_tpu_torch.config import Config
from hobbyrenderer_tpu_torch.models import scene_rt as tsrt
from hobbyrenderer_tpu_torch.ops import denoise as tdn
from hobbyrenderer_tpu_torch.ops import lights as tlights
from hobbyrenderer_tpu_torch.ops import raster as traster
from hobbyrenderer_tpu_torch.ops import regir as tregir
from hobbyrenderer_tpu_torch.ops import restir as trestir
from hobbyrenderer_tpu_torch.renderer import Renderer as TorchRenderer
from tests.torch_parity import same_mesh_cooker

W, H = 96, 64
FRAMES = 3
W_RTOL = 1e-5
BOUNDARY = 1e-3
_CACHE = {}


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


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _frames(tmp_root):
    """The JAX ReGIR frame (onion cells), 3 frames: per frame its G-buffer,
    denoised direct light and reservoirs before and after, with the port's
    Renderer of the same config (its scene, pool and view constants)."""
    if _CACHE:
        return _CACHE
    kw = dict(scene="stress:2", width=W, height=H, direct_mode="restir", regir=True,
              regir_mode="onion", cache_dir=os.path.join(str(tmp_root), "regir"))
    jr = JaxRenderer(JaxConfig(**kw))
    m = jr._model

    def fn(gpu, rt, vc, settings, state, dt):
        ctx = FrameContext(gpu=gpu, vc=vc, settings=settings, config=m.config, dt=dt, rt=rt)
        out = m.graph.execute(ctx, state, outputs=("ldr", "raster_overflow", "gbuffer",
                                                   "restir_direct"))
        o = out["outputs"]
        return o["ldr"], {k: o[k] for k in ("raster_overflow", "gbuffer", "restir_direct")}, \
            out["state"]

    m._jitted = jax.jit(fn, donate_argnums=(4,))
    tr = TorchRenderer(Config(**kw), device="cpu")
    frames = []
    for k in range(FRAMES):
        vc = tr.view_constants()
        tr.camera.end_frame()
        tr.frame_index += 1
        before = _np({n: m.state[n] for n in ("restir_reservoir", "denoise_state")})
        jr.render_frame()
        frames.append(dict(vc=vc, before=before, gb=_np(m.last_stats["gbuffer"]),
                           after=_np({n: m.state[n] for n in ("restir_reservoir",)}),
                           direct=np.asarray(m.last_stats["restir_direct"])))
    jr.shutdown()
    tr.shutdown()
    pool = m.rt.lights
    _CACHE.update(frames=frames, tr=tr, jpool=pool, tpool=tlights.LightPool(
        n_analytic=int(pool.n_analytic), n_total=int(pool.n_total),
        **{k: torch.as_tensor(np.asarray(getattr(pool, k)).astype(
            np.int64 if k == "em_orig" else np.float32)) for k in tsrt.POOL_FIELDS}))
    return _CACHE


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return _frames(tmp_path_factory.mktemp("torch_regir"))


def _jgrid(run, k, mode):
    """The JAX package's cells of frame k (built once; the cell RIS jitted,
    as it is inside the JAX frame)."""
    if (k, mode) not in run:
        tr = run["tr"]
        build_cells = jregir._build_cells
        jregir._build_cells = jax.jit(build_cells, static_argnums=(3, 4))
        try:
            if mode == "onion":
                run[k, mode] = jregir.build_regir_onion(
                    run["jpool"], jnp.asarray(run["frames"][k]["vc"]["camera_pos"].numpy()),
                    tr.gpu.meta["scene_radius"], k)
            else:
                lo, hi = tr.gpu.meta["scene_bounds"]
                run[k, mode] = jregir.build_regir_grid(run["jpool"], jnp.asarray(lo),
                                                       jnp.asarray(hi), k)
        finally:
            jregir._build_cells = build_cells
    return run[k, mode]


def _tgrid(run, k, mode):
    tr = run["tr"]
    if mode == "onion":
        return tregir.build_regir_onion(run["tpool"], run["frames"][k]["vc"]["camera_pos"],
                                        tr.gpu.meta["scene_radius"], k)
    lo, hi = tr.gpu.meta["scene_bounds"]
    return tregir.build_regir_grid(run["tpool"], lo, hi, k)


@pytest.mark.parametrize("mode,cells", [("onion", 1080), ("grid", 864)])
def test_cell_build_matches_jax(run, mode, cells):
    want = np.asarray(_jgrid(run, 2, mode).rows)
    got = _tgrid(run, 2, mode).rows.numpy()
    assert got.shape == want.shape == (cells, 128, 18)
    np.testing.assert_array_equal(got[..., 17], want[..., 17])       # light ids
    assert (want[..., 17] >= 0).mean() > 0.5, "degenerate case"
    np.testing.assert_array_equal(got[..., :16], want[..., :16])     # packed rows
    np.testing.assert_allclose(got[..., 16], want[..., 16], rtol=W_RTOL, atol=0)


def _near_int(x):
    return np.abs(x - np.round(x)) < BOUNDARY


@pytest.mark.parametrize("mode", ["onion", "grid"])
def test_cells_of_positions_match_jax(run, mode):
    """Random points around the camera out past the scene radius; lanes
    near a cell boundary are excluded (torch and XLA may floor a log or an
    arctan2 there to neighbouring cells) and counted."""
    jg, tg = _jgrid(run, 2, mode), _tgrid(run, 2, mode)
    rng = np.random.default_rng(17)
    rad = 1.3 * float(run["tr"].gpu.meta["scene_radius"])
    cam = run["frames"][2]["vc"]["camera_pos"].numpy().astype(np.float64)
    pos = (cam + rng.uniform(-rad, rad, (20000, 3))).astype(np.float32)
    valid = rng.uniform(size=20000) < 0.95
    got = tregir.cells_of_positions(tg, torch.as_tensor(pos), torch.as_tensor(valid)).numpy()
    want = np.asarray(jregir.cells_of_positions(jg, jnp.asarray(pos), jnp.asarray(valid)))
    p = pos.astype(np.float64)
    if mode == "onion":
        n_det, n_cov, n_az, n_el = tg.onion_dims
        rel = p - np.asarray(tg.cam, np.float64)
        r = np.linalg.norm(rel, axis=-1)
        rd, rmax = float(tg.r_detail), float(tg.r_max)
        layer = np.where(r < rd, r / rd * n_det,
                         n_det + np.log(np.maximum(r / rd, 1.0)) / np.log(
                             (rmax / rd) ** (1.0 / n_cov)))
        az = (np.arctan2(rel[:, 2], rel[:, 0]) + np.pi) / (2 * np.pi) * n_az
        el = (np.arcsin(np.clip(rel[:, 1] / r, -1, 1)) + np.pi / 2) / np.pi * n_el
        near = _near_int(layer) | _near_int(az) | _near_int(el) | (np.abs(r - rd) < BOUNDARY)
    else:
        q = (p - np.asarray(tg.lo)) * np.asarray(tg.inv_cell)
        near = _near_int(q).any(-1)
    near &= valid
    print(f"{mode}: {int(near.sum())} of {len(near)} lanes near a cell boundary left out")
    assert near.mean() < 0.02, f"{int(near.sum())} of {len(near)} lanes near a boundary"
    np.testing.assert_array_equal(got[~near], want[~near])
    assert len(np.unique(got[valid])) > 100, "degenerate case"


def _gbuffer(g):
    return traster.GBuffer(*[torch.as_tensor(np.array(getattr(g, f)))
                             for f in traster.GBuffer._fields])


def _reservoir(r):
    return trestir.Reservoir(y=torch.as_tensor(np.asarray(r.y).astype(np.int64)),
                             uv=torch.as_tensor(r.uv), w_sum=torch.as_tensor(r.w_sum),
                             M=torch.as_tensor(r.M), W=torch.as_tensor(r.W))


@pytest.mark.parametrize("frame", [1, 2], ids=["frame2", "frame3"])
def test_restir_di_with_regir_matches_jax(run, frame):
    """restir_di with the JAX frame's onion cells (converted), on its
    G-buffer with its previous reservoir, straggler caps lifted: the gate of
    test_torch_restir.py::test_restir_di_matches_jax."""
    f, tr = run["frames"][frame], run["tr"]
    jg = _jgrid(run, frame, "onion")
    grid = tregir.RegirGrid(rows=torch.as_tensor(np.array(jg.rows)),
                            lo=tuple(np.asarray(jg.lo).tolist()),
                            inv_cell=tuple(np.asarray(jg.inv_cell).tolist()), dims=jg.dims,
                            mode="onion", cam=torch.as_tensor(np.array(jg.cam)),
                            onion_dims=jg.onion_dims, r_detail=float(jg.r_detail),
                            r_max=float(jg.r_max))
    so = {}
    out, res = trestir.restir_di(
        tr.gpu, tr._model.rt, _gbuffer(f["gb"]), f["vc"], tr.config.settings,
        _reservoir(f["before"]["restir_reservoir"]), frame, num_candidates=8,
        spatial_taps=2, boiling_mult=20.0, vis_scale=2, regir_grid=grid, stats_out=so,
        straggler_steps=None)
    y_j = np.asarray(f["after"]["restir_reservoir"].y)
    valid = np.asarray(f["gb"].valid)
    assert np.mean(y_j[valid] >= 0) > 0.5, "degenerate case"
    assert np.mean(res.y.numpy() == y_j) > 0.98, np.mean(res.y.numpy() == y_j)
    ds = f["before"]["denoise_state"]
    den, _ = tdn.denoise(out, _gbuffer(f["gb"]), tdn.DenoiseState(
        *[torch.as_tensor(np.asarray(a)) for a in ds]))
    want = f["direct"]
    rel = np.abs(den.numpy() - want).sum() / (np.abs(want).sum() + 1e-6)
    assert rel < 0.02, rel
    assert int(so["overflow"]) == 0 and int(so["k3_capped"]) == 0
