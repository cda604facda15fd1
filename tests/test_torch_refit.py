"""The per-frame refit of an animated scene in the PyTorch port against the
JAX package on the CPU: stress:2's RT scene (built the same way by both),
some instances (every emissive one among them) moved rigidly, then
refit_scene_rt in both packages. Held: the 4-wide tree (refit_bvh), its
beam table (beam_table on the refitted tensors), the 16-wide tree
(refit_bvh16: the port's row-major table against from_jax_table of the
JAX one, the root box and the leaf records), and the light pool
(refit_light_pool); refresh_pool_emissive after an emissive material
changes; the plain K3 walk on the refitted 16-wide table against JAX
bvh16_closest_hit on the JAX package's refitted tree; and the refit run
twice giving the same bits.

Tolerance: boxes are minima and maxima of vertices, so a box differs from
JAX's only where a vertex does. The vertex transform rounds differently:
the port multiplies and adds in a fixed order (ops tmath.affine_points /
matmul4: the same bits on the CPU and the GPU), XLA:CPU contracts into
fused multiply-adds. Bound: |d| <= 2^-20 * max(1, |x|) per coordinate (a
few ulp of the scene's extent). Triangle ids and the tree's topology are
exact. The walk: the same triangle on >= 99.9% of rays (a ray grazing an
edge may pick the neighbour when its vertices moved by an ulp), t within
1e-5 relative or 2^-20 of the scene's extent where the triangles agree."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.models import pathtracer as jpt
from hobbyrenderer_tpu.ops import bvh16 as jb16
from hobbyrenderer_tpu.ops import lights as jlights
from hobbyrenderer_tpu.scene import make_stress_scene as jax_make_stress_scene
from hobbyrenderer_tpu.scene.gpu import build_scene_gpu as jax_build_scene_gpu
from hobbyrenderer_tpu.scene.gpu import update_material_constants as jax_update_materials
from hobbyrenderer_tpu_torch.models import scene_rt as tsrt
from hobbyrenderer_tpu_torch.ops import bvh16 as tb16
from hobbyrenderer_tpu_torch.ops import lights as tlights
from hobbyrenderer_tpu_torch.scene import gpu as tgpu
from hobbyrenderer_tpu_torch.scene.procedural import make_stress_scene
from tests.torch_parity import same_mesh_cooker

REL = 2.0 ** -20
R = 4096
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


def _moved_transforms(scene, seed=0):
    """Every emissive instance and instances 1 and 3 moved: each world
    matrix pre-multiplied by a rotation about +y and a translation."""
    rng = np.random.default_rng(seed)
    W = np.stack([scene.nodes[I.node].world for I in scene.instances]).astype(np.float32)
    em = [i for i, I in enumerate(scene.instances)
          if np.any(np.asarray(scene.materials[I.material].emissive) > 0)]
    moved = sorted(set(em) | {1, 3})
    for i in moved:
        a = rng.uniform(0, 2 * np.pi)
        c, s = np.cos(a), np.sin(a)
        M = np.asarray([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]], np.float64)
        M[:3, 3] = rng.uniform(-1.5, 1.5, 3)
        W[i] = (M @ W[i]).astype(np.float32)
    return W, moved, em


def _setup():
    if _CACHE:
        return _CACHE
    jscene, tscene = jax_make_stress_scene(grid=2), make_stress_scene(grid=2)
    for scene in (jscene, tscene):      # stress:2 has no emitter: make instance 2's material one
        scene.materials[scene.instances[2].material].emissive = np.asarray([3.0, 2.0, 1.0],
                                                                            np.float32)
    nl = max(64, len(tscene.lights) + 8)
    jg = jax_build_scene_gpu(jscene, max_lights=nl)
    tg = tgpu.build_scene_gpu(tscene, "cpu", max_lights=nl)
    jrt = jpt.build_scene_rt(jscene, jg)
    trt = tsrt.build_scene_rt(tscene, "cpu", gpu=tg)
    W, moved, em = _moved_transforms(tscene)
    jref = jpt.refit_scene_rt(jrt, jnp.asarray(W))
    tref = tsrt.refit_scene_rt(trt, torch.as_tensor(W))
    _CACHE.update(jscene=jscene, tscene=tscene, jg=jg, tg=tg, jrt=jrt, trt=trt, W=W,
                  moved=moved, em=em, jref=jref, tref=tref)
    return _CACHE


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    bound = REL * np.maximum(1.0, np.abs(want))
    bad = np.abs(got - want) > bound
    assert not bad.any(), (what, int(bad.sum()), float(np.abs(got - want).max()))


def test_refit_inputs_match_jax():
    """The load-time inverses and the builds the refit starts from."""
    s = _setup()
    np.testing.assert_array_equal(s["trt"].inst_inv0.numpy(), np.asarray(s["jrt"].inst_inv0))
    np.testing.assert_array_equal(s["trt"].bvh16.table.numpy(),
                                  tb16.from_jax_table(np.asarray(s["jrt"].bvh16.table)))
    assert s["em"], "stress:2 has no emissive instance"


def test_refit_bvh_and_beam_table_match_jax():
    s = _setup()
    tb, jb = s["tref"].bvh, s["jref"].bvh
    table, want = tb.table.numpy(), np.asarray(jb.table)
    # leaf triangle ids (lane 9 of each 10-lane record) exactly
    L = (3 * want.shape[0] + 1) // 4
    I = (L - 1) // 3
    np.testing.assert_array_equal(table[I:].reshape(-1, 10)[:, 9], want[I:].reshape(-1, 10)[:, 9])
    _close(table, want, "bvh table")
    _close(tb.root_box.numpy(), np.asarray(jb.root_box), "root box")
    assert not np.array_equal(table, np.asarray(s["jrt"].bvh.table)), "nothing moved"
    _close(s["tref"].btable.numpy(), np.asarray(s["jref"].btable), "beam table")


def test_refit_bvh16_matches_jax():
    s = _setup()
    tb, jb = s["tref"].bvh16, s["jref"].bvh16
    _close(tb.table.numpy(), tb16.from_jax_table(np.asarray(jb.table)), "bvh16 table")
    _close(tb.root_box.numpy(), np.asarray(jb.root_box), "bvh16 root box")
    _close(tb.recs.numpy(), np.asarray(jb.recs), "bvh16 records")
    assert tb.table.is_contiguous() and tb.recs.is_contiguous()


def test_refit_light_pool_matches_jax():
    s = _setup()
    tp, jp = s["tref"].lights, s["jref"].lights
    for k in ("em_v0", "em_e1", "em_e2", "packed"):
        _close(getattr(tp, k).numpy(), np.asarray(getattr(jp, k)), k)
    # the power is not recomputed by a rigid move
    assert torch.equal(tp.power_cdf, s["trt"].lights.power_cdf)
    np.testing.assert_array_equal(np.asarray(jp.power_cdf), np.asarray(s["jrt"].lights.power_cdf))


def test_refresh_pool_emissive_matches_jax():
    """An emissive material's strength changes: the material rows and the
    pool's radiance equal JAX's, its pdf within 1e-6 relative, its CDF
    (summed on the host) within 1e-6."""
    s = _setup()
    mat = s["tscene"].instances[s["em"][0]].material
    for scene in (s["jscene"], s["tscene"]):
        scene.materials[mat].emissive_strength = 7.5
        scene.dirty_materials = {mat}
    jg = jax_update_materials(s["jg"], s["jscene"])
    tg = tgpu.update_material_constants(s["tg"], s["tscene"])
    np.testing.assert_array_equal(tg.mat_f.numpy(), np.asarray(jg.mat_f))
    tp = tlights.refresh_pool_emissive(s["trt"].lights, tg, s["trt"].tri_mat)
    jp = jlights.refresh_pool_emissive(s["jrt"].lights, jg, s["jrt"].tri_mat)
    np.testing.assert_array_equal(tp.em_rad.numpy(), np.asarray(jp.em_rad))
    assert not torch.equal(tp.em_rad, s["trt"].lights.em_rad)
    np.testing.assert_allclose(tp.power_pdf.numpy(), np.asarray(jp.power_pdf), rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(tp.power_cdf.numpy(), np.asarray(jp.power_cdf), atol=1e-6)
    np.testing.assert_array_equal(tp.packed.numpy()[:, 10:13], np.asarray(jp.packed)[:, 10:13])


def test_refit_walk_matches_jax():
    """The plain K3 walk on the port's refitted 16-wide table against the
    JAX walk on the JAX package's refitted tree: rays from inside the moved
    scene's box in random directions."""
    s = _setup()
    tb, jb = s["tref"].bvh16, s["jref"].bvh16
    rng = np.random.default_rng(1)
    box = tb.root_box.numpy()
    o = rng.uniform(box[:3], box[3:], (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hj = jb16.bvh16_closest_hit(jb, jnp.asarray(o), jnp.asarray(d), mxu=False)
    ht = tb16.bvh16_closest_hit(tb, torch.as_tensor(o), torch.as_tensor(d))
    tri_j, tri_t = np.asarray(hj.tri), ht.tri.numpy()
    same = tri_j == tri_t
    assert same.mean() >= 0.999, same.mean()
    hit = same & (tri_j >= 0)
    assert 0.2 < hit.mean() < 0.95, "degenerate case"
    np.testing.assert_allclose(ht.t.numpy()[hit], np.asarray(hj.t)[hit], rtol=1e-5,
                               atol=REL * float(np.abs(box).max()))


def test_refit_same_bits_twice():
    """The refit is a function of its inputs: run again, the same bits."""
    s = _setup()
    again = tsrt.refit_scene_rt(s["trt"], torch.as_tensor(s["W"]))
    for a, b in ((again.bvh.table, s["tref"].bvh.table), (again.btable, s["tref"].btable),
                 (again.bvh16.table, s["tref"].bvh16.table),
                 (again.lights.packed, s["tref"].lights.packed)):
        assert torch.equal(a, b)
