"""The DDGI probe update and query of the PyTorch port against the JAX
package on the CPU, at op level: one ddgi_update from ddgi_init on stress:2
in both packages, the port on the JAX SceneGPU and SceneRT carried across
by scene_gpu_from_numpy / scene_rt_from_numpy; then ddgi_query on the
updated volume. The NormalBasic + DDGI frame is in
tests/test_torch_ddgi_frame.py.

The JAX CPU path walks the 4-wide BVH, the port the 16-wide one (K3's
plain version), so hit distances may differ by rounding: hits are compared
ray for ray by triangle, the textures by their relative L1 distance."""

import jax
import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.config import Config as JaxConfig
from hobbyrenderer_tpu.models import pathtracer as jpt
from hobbyrenderer_tpu.ops import ddgi as jddgi
from hobbyrenderer_tpu.ops import trace as jtrace
from hobbyrenderer_tpu.scene import make_stress_scene
from hobbyrenderer_tpu.scene.gpu import build_scene_gpu as jax_build_scene_gpu
from hobbyrenderer_tpu_torch.config import Config
from hobbyrenderer_tpu_torch.models import scene_rt as tsrt
from hobbyrenderer_tpu_torch.ops import bvh16 as tb16
from hobbyrenderer_tpu_torch.ops import ddgi as tddgi
from hobbyrenderer_tpu_torch.scene.gpu import scene_gpu_from_numpy
from tests.torch_parity import same_mesh_cooker

VOL_FIELDS = ("irradiance", "distance", "alive", "offset", "variability")


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


_CACHE = {}


def _jax_update(vol, jg, jrt, settings):
    """One jitted JAX ddgi_update at frame 0, returning the volume and the
    probe rays' closest hits (caught on their way through the update)."""
    seen = {}
    orig = jtrace.closest_hit_auto

    def spy(*a, **k):
        hit = orig(*a, **k)
        seen["hit"] = hit
        return hit

    def run(v, g, r):
        out = jddgi.ddgi_update(v, g, r, settings, 0)
        return out, seen["hit"].tri, seen["hit"].t

    jtrace.closest_hit_auto = spy
    try:
        return jax.jit(run)(vol, jg, jrt)
    finally:
        jtrace.closest_hit_auto = orig


@pytest.fixture(scope="module")
def update():
    """Both packages' volumes after one update from ddgi_init, and both
    packages' probe-ray hits."""
    if _CACHE:
        return _CACHE
    scene = make_stress_scene(grid=2)
    jg = jax_build_scene_gpu(scene, max_lights=max(64, len(scene.lights) + 8))
    jrt = jpt.build_scene_rt(scene, jg)
    tg = scene_gpu_from_numpy({k: np.asarray(getattr(jg, k)) for k in jg.__dataclass_fields__
                               if getattr(jg, k) is not None}, "cpu")
    d = {k: np.asarray(getattr(jrt, k)) for k in tsrt.RT_FIELDS + tsrt.TABLE_FIELDS}
    d["bvh16"] = {k: np.asarray(getattr(jrt.bvh16, k))
                  for k in ("table", "order", "root_box", "recs", "slot_of")}
    d["lights"] = {k: np.asarray(getattr(jrt.lights, k))
                   for k in ("n_analytic", "n_total") + tsrt.POOL_FIELDS}
    d["em_index"] = np.asarray(jrt.em_index)
    trt = tsrt.scene_rt_from_numpy(d, "cpu")
    lo, hi = tg.meta["scene_bounds"]

    jvol, jtri, jt = _jax_update(jddgi.ddgi_init(lo, hi), jg, jrt, JaxConfig().settings)
    walks = []
    orig = tb16.bvh16_walk

    def spy(table, o, d, t_max, any_hit, *a, **k):
        out = orig(table, o, d, t_max, any_hit, *a, **k)
        walks.append((any_hit, o, d, out))
        return out

    tb16.bvh16_walk = spy
    so = {}
    try:
        tvol = tddgi.ddgi_update(tddgi.ddgi_init(lo, hi, "cpu"), tg, trt, Config().settings, 0,
                                 stats_out=so)
    finally:
        tb16.bvh16_walk = orig
    _CACHE.update(
        jvol={k: np.array(getattr(jvol, k)) for k in VOL_FIELDS},
        tvol={k: getattr(tvol, k).numpy() for k in VOL_FIELDS},
        tvol_t=tvol, jvol_j=jvol, jtri=np.asarray(jtri), jt=np.asarray(jt),
        probe_walk=next(w for w in walks if not w[0]), stats=so, lo=lo, hi=hi)
    return _CACHE


def test_probe_ray_hits_match_jax(update):
    """All 256 x 64 probe rays of the first update: the directions are the
    JAX package's; closest-hit triangles equal on every ray the 16-wide walk
    finishes under its budget (measured: all of them finish, all agree)."""
    _any, o, d, (t, tri, steps) = update["probe_walk"]
    assert o.shape[0] == 256 * tddgi.N_RAYS == update["jtri"].shape[0]
    jdirs = np.asarray(jddgi._fibonacci_dirs(jddgi.N_RAYS)) @ np.asarray(jddgi._rand_rotation(0)).T
    np.testing.assert_allclose(d.numpy()[:jddgi.N_RAYS], jdirs, atol=1e-6)
    done = steps.numpy() < tb16.UNCAPPED_STEPS
    same = tri.numpy() == update["jtri"]
    assert np.mean(update["jtri"] >= 0) > 0.05, "probe rays hit too little"
    assert done.mean() >= 0.999, done.mean()
    assert same[done].all(), np.mean(same[done])
    # hit distances: the two walks' Moller-Trumbore rounding (measured 7.7e-6)
    hit = same & done & (update["jtri"] >= 0)
    np.testing.assert_allclose(t.numpy()[hit], update["jt"][hit], rtol=1e-4)


def test_probe_volume_after_first_update_matches_jax(update):
    """alive equal on every probe; irradiance and the distance moments
    within 1e-4 relative L1 (measured 7.1e-7 and 7.7e-8: the same hits,
    rounding in the sky march and the blends); the relocation offsets to
    1e-5 (measured 3.0e-8) and the variability (1: the volume starts at
    zero) equal."""
    jv, tv = update["jvol"], update["tvol"]
    np.testing.assert_array_equal(tv["alive"], jv["alive"])
    for field in ("irradiance", "distance"):
        rel = np.abs(tv[field] - jv[field]).sum() / np.abs(jv[field]).sum()
        assert rel <= 1e-4, (field, rel)
    assert np.abs(jv["irradiance"]).sum() > 0
    np.testing.assert_allclose(tv["offset"], jv["offset"], atol=1e-5)
    assert float(tv["variability"]) == float(jv["variability"]) == 1.0
    # the NEE shadow rays of the hit shading ran through the walk
    assert int(update["stats"]["k3_lanes"]) > 0


def test_ddgi_query_matches_jax(update):
    """The 8-probe query on the updated volumes at points inside the scene
    bounds: within 1e-5 relative L1 (measured 6.9e-7: the volumes differ
    by rounding)."""
    rng = np.random.default_rng(7)
    lo, hi = (np.asarray(b, np.float32) for b in (update["lo"], update["hi"]))
    pos = rng.uniform(lo, hi, (2048, 3)).astype(np.float32)
    nrm = rng.normal(size=(2048, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    want = np.asarray(jax.jit(jddgi.ddgi_query)(update["jvol_j"], pos, nrm))
    got = tddgi.ddgi_query(update["tvol_t"], torch.as_tensor(pos), torch.as_tensor(nrm)).numpy()
    assert got.shape == want.shape == (2048, 3)
    assert np.abs(want).sum() > 0
    rel = np.abs(got - want).sum() / np.abs(want).sum()
    assert rel <= 1e-5, rel
