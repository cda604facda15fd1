"""The 16-wide BVH of the PyTorch port against the JAX package: the build
(row-major table = the JAX table transposed), the walk's plain version
against ``bvh16_closest_hit`` / ``bvh16_any_hit`` (mxu=False, a single
phase below 16384 rays) capped and uncapped, uncapped any hit against the
4-wide ``bvh_any_hit``, and the SceneRT carried across from the JAX
package; on a GPU, the walk kernel (K3) against its plain version.

XLA:CPU contracts some products into fused multiply-adds, the port rounds
every product and sum separately, so hit distances differ by a few ulp on
some rays; the hit triangle, the occlusion and the hit/miss split agree
exactly."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.models import pathtracer as jpt
from hobbyrenderer_tpu.ops import bvh as jbvh
from hobbyrenderer_tpu.ops import bvh16 as jb16
from hobbyrenderer_tpu.scene import make_stress_scene as jax_make_stress_scene
from hobbyrenderer_tpu.scene.gpu import build_scene_gpu as jax_build_scene_gpu
from hobbyrenderer_tpu_torch.models import scene_rt as tsrt
from hobbyrenderer_tpu_torch.ops import bvh16 as tb16
from hobbyrenderer_tpu_torch.ops import trace as ttrace
from hobbyrenderer_tpu_torch.scene.procedural import make_stress_scene

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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel); run by chip_smoke.py on the card")
    return torch.device("cuda")


def _setup():
    """stress:2 split triangles, both builds, and rays: R/2 random rays from
    inside the scene box (closest hit), R/2 shadow-like rays toward points
    of the scene with finite t_max (any hit)."""
    if "s" in _CACHE:
        return _CACHE["s"]
    verts = tsrt.build_scene_rt(make_stress_scene(grid=2), "cpu").split_world0.numpy()
    jbv = jb16.build_bvh16(verts)
    tbv = tb16.build_bvh16(verts, "cpu")
    rng = np.random.default_rng(0)
    lo, hi = np.asarray(jbv.root_box[:3]), np.asarray(jbv.root_box[3:])
    o = rng.uniform(lo, hi, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # shadow-like half: toward a random scene point, stopping short of it
    tgt = rng.uniform(lo, hi, (R // 2, 3)).astype(np.float32)
    v = tgt - o[R // 2:]
    dist = np.linalg.norm(v, axis=1)
    d[R // 2:] = v / dist[:, None]
    tmax = np.full(R, 3.0e38, np.float32)
    tmax[R // 2:] = dist - 1e-3
    _CACHE["s"] = (verts, jbv, tbv, o, d, tmax)
    return _CACHE["s"]


def test_build_bvh16_matches_jax():
    verts, jbv, tbv, *_ = _setup()
    want = jb16.build_bvh16(verts, device_put=False)
    np.testing.assert_array_equal(tbv.table.numpy(), tb16.from_jax_table(want.table))
    for k in ("order", "root_box", "recs", "slot_of"):
        np.testing.assert_array_equal(getattr(tbv, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    # leaf_rw, the JAX walk kernel's row-major leaf table, is the table's leaf rows
    I = want.n_interior
    np.testing.assert_array_equal(tbv.table.numpy()[I:], np.asarray(want.leaf_rw))
    assert (tbv.num_leaves, tbv.n_interior, tbv.depth) == (want.num_leaves, I, want.depth)


@pytest.mark.parametrize("max_steps", [None, 8], ids=["uncapped", "capped8"])
def test_plain_walk_closest_matches_jax(max_steps):
    _, jbv, tbv, o, d, tmax = _setup()
    hj = jb16.bvh16_closest_hit(jbv, jnp.asarray(o), jnp.asarray(d), t_max=jnp.asarray(tmax),
                                max_steps=max_steps, mxu=False)
    ht = tb16.bvh16_closest_hit(tbv, torch.as_tensor(o), torch.as_tensor(d),
                                t_max=torch.as_tensor(tmax), max_steps=max_steps)
    tri_j, t_j = np.asarray(hj.tri), np.asarray(hj.t)
    np.testing.assert_array_equal(ht.tri.numpy(), tri_j)
    hit = tri_j >= 0
    assert 0.2 < hit.mean() < 0.95, "degenerate case"
    np.testing.assert_array_equal(ht.t.numpy()[~hit], t_j[~hit])
    np.testing.assert_allclose(ht.t.numpy()[hit], t_j[hit], rtol=2e-6, atol=1e-9)
    np.testing.assert_array_equal(ht.front.numpy(), np.asarray(hj.front))
    np.testing.assert_allclose(ht.u.numpy(), np.asarray(hj.u), atol=1e-4)
    if max_steps is not None:
        # the cap must bind on some rays for the capped case to mean anything
        _, _, steps = tb16.bvh16_walk_reference(tbv.table, torch.as_tensor(o),
                                                torch.as_tensor(d), torch.as_tensor(tmax),
                                                False, max_steps)
        assert (steps == max_steps).float().mean() > 0.05


@pytest.mark.parametrize("max_steps", [None, 8], ids=["uncapped", "capped8"])
def test_plain_walk_any_matches_jax(max_steps):
    _, jbv, tbv, o, d, tmax = _setup()
    want = np.asarray(jb16.bvh16_any_hit(jbv, jnp.asarray(o), jnp.asarray(d),
                                         t_max=jnp.asarray(tmax), max_steps=max_steps,
                                         mxu=False))
    got, capped = tb16.bvh16_any_hit(tbv, torch.as_tensor(o), torch.as_tensor(d),
                                     t_max=torch.as_tensor(tmax), max_steps=max_steps,
                                     return_capped=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.2 < want.mean() < 0.95, "degenerate case"
    assert (capped.float().mean() > 0.01) == (max_steps is not None)


def test_plain_walk_any_uncapped_matches_4wide_bvh():
    verts, _, tbv, o, d, tmax = _setup()
    want = np.asarray(jbvh.bvh_any_hit(jbvh.build_bvh(verts), jnp.asarray(o), jnp.asarray(d),
                                       t_max=jnp.asarray(tmax)))
    got = ttrace.any_hit_auto(tsrt.SceneRT(None, None, None, None, None, bvh16=tbv),
                              torch.as_tensor(o), torch.as_tensor(d),
                              t_max=torch.as_tensor(tmax))
    np.testing.assert_array_equal(got.numpy(), want)


def test_trace_dispatch_masks_and_converts_budget():
    _, _, tbv, o, d, tmax = _setup()
    rt = tsrt.SceneRT(None, None, None, None, None, bvh16=tbv)
    o, d, tmax = torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax)
    active = torch.arange(R) % 3 != 0
    h = ttrace.closest_hit_auto(rt, o, d, active=active, max_steps=40)   # 24 walk steps
    ref = tb16.bvh16_closest_hit(tbv, o, d, t_max=torch.where(active, ttrace.TMAX_CAP, 0.0),
                                 max_steps=24)
    assert torch.equal(h.tri, ref.tri) and not (h.tri[~active] >= 0).any()
    occ = ttrace.any_hit_auto(rt, o, d, t_max=tmax, active=active)
    assert not occ[~active].any()
    assert torch.equal(occ[active], tb16.bvh16_any_hit(tbv, o, d, t_max=tmax)[active])


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_plain_walk_visited_rows(any_hit):
    """The rows the plain walk reports read: one new row per step of each
    ray (a tree walk reads no row twice), the batch's set is the union of
    the rays' sets, and every read row's parent was read."""
    _, _, tbv, o, d, tmax = _setup()
    pick = np.arange(3) + (R // 2 if any_hit else 0)
    o, d, tmax = (torch.as_tensor(a[pick]) for a in (o, d, tmax))
    *_, steps, seen = tb16.bvh16_walk_reference(tbv.table, o, d, tmax, any_hit,
                                                return_visited=True)
    union = torch.zeros_like(seen)
    for i in range(len(pick)):
        *_, s_i, seen_i = tb16.bvh16_walk_reference(tbv.table, o[i:i + 1], d[i:i + 1],
                                                    tmax[i:i + 1], any_hit,
                                                    return_visited=True)
        assert int(s_i[0]) == int(steps[i]) == int(seen_i.sum())
        union |= seen_i
    assert torch.equal(union, seen) and int(steps.max()) > 3
    rows = torch.nonzero(seen).flatten()
    assert bool(seen[0]) and bool(seen[(rows[rows > 0] - 1) // 16].all())


def test_scene_rt_from_jax_carries_bvh16_and_pool():
    jscene = jax_make_stress_scene(grid=2)
    jg = jax_build_scene_gpu(jscene, max_lights=max(64, len(jscene.lights) + 8))
    jrt = jpt.build_scene_rt(jscene, jg)
    d = {k: np.asarray(getattr(jrt, k)) for k in tsrt.RT_FIELDS}
    d["bvh16"] = {k: np.asarray(getattr(jrt.bvh16, k))
                  for k in ("table", "order", "root_box", "recs", "slot_of")}
    d["lights"] = {k: np.asarray(getattr(jrt.lights, k))
                   for k in ("n_analytic", "n_total") + tsrt.POOL_FIELDS}
    d["em_index"] = np.asarray(jrt.em_index)
    conv = tsrt.scene_rt_from_numpy(d, "cpu")
    scene = make_stress_scene(grid=2)
    from hobbyrenderer_tpu_torch.scene.gpu import build_scene_gpu
    own = tsrt.build_scene_rt(scene, "cpu",
                              gpu=build_scene_gpu(scene, "cpu",
                                                  max_lights=max(64, len(scene.lights) + 8)))
    for k in ("table", "order", "root_box", "recs", "slot_of"):
        assert torch.equal(getattr(conv.bvh16, k), getattr(own.bvh16, k)), k
    assert torch.equal(conv.em_index, own.em_index)
    assert (conv.lights.n_analytic, conv.lights.n_total) == (own.lights.n_analytic,
                                                               own.lights.n_total)
    for k in tsrt.POOL_FIELDS:
        np.testing.assert_allclose(getattr(own.lights, k).numpy(),
                                   getattr(conv.lights, k).numpy(), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("R", [1, 4093, 16_200, 65_536, 100_003, 323_584, 518_400])
def test_k3_launch_grid(R):
    """Persistent CTAs: never more than the card keeps resident, and no
    more than give each ray a half-warp."""
    per_cta = tb16.RAYS_A_CTA
    for resident in (264, 1056, 1):
        grid = tb16.launch_grid(R, resident)
        assert 1 <= grid <= resident
        assert grid * per_cta >= min(R, resident * per_cta)   # every ray or CTA slot busy
        assert (grid - 1) * per_cta < R                        # no CTA without a ray


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_bench_k3_baseline_walks_another_checkout(any_hit):
    """bench_k3 --baseline imports another checkout's walk module (here this
    checkout's, as a second copy) and leaves this process's modules as they
    were; the copy walks CPU rays as the plain walk does."""
    import hobbyrenderer_tpu_torch
    from hobbyrenderer_tpu_torch import bench_k3, kernels
    root = os.path.dirname(os.path.dirname(os.path.abspath(hobbyrenderer_tpu_torch.__file__)))
    base = bench_k3.load_baseline(root)
    assert base is not tb16 and base.kernels is not kernels
    assert sys.modules["hobbyrenderer_tpu_torch.ops.bvh16"] is tb16
    assert sys.modules["hobbyrenderer_tpu_torch.kernels"] is kernels
    _, _, tbv, o, d, tmax = _setup()
    o, d, tmax = (torch.as_tensor(a[:512]) for a in (o, d, tmax))
    got = base.bvh16_walk(tbv.table, o, d, tmax, any_hit, 64)
    ref = tb16.bvh16_walk_reference(tbv.table, o, d, tmax, any_hit, 64)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="no hobbyrenderer_tpu_torch"):
        bench_k3.load_baseline(os.path.join(root, "tests"))
    assert sys.modules["hobbyrenderer_tpu_torch.ops.bvh16"] is tb16


def test_bench_k3_scene_rays_and_bound():
    """bench_k3's synthetic walk: unit directions from inside the scene box,
    the second half aimed at scene points with t_max short of them, every
    third ray masked; its bound is the larger of its bytes and operations,
    counted from the plain walk's rows (384 B an interior row, 480 B a leaf
    row) and steps."""
    from hobbyrenderer_tpu_torch import bench_k3
    tbv = _setup()[2]
    n = 1001
    o, d, tm = bench_k3.scene_rays(tbv.root_box, n, device="cpu")
    assert o.shape == d.shape == (n, 3) and tm.shape == (n,)
    assert torch.allclose(d.norm(dim=1), torch.ones(n), atol=1e-5)
    assert ((o >= tbv.root_box[:3]) & (o <= tbv.root_box[3:])).all()
    masked = torch.arange(n) % 3 == 0
    assert (tm[masked] == np.float32(1e-4)).all() and (tm[~masked] > 1e-4).all()
    far = ~masked & (torch.arange(n) < n // 2)
    assert (tm[far] == np.float32(3.0e38)).all() and (tm[n // 2:] < 1e30).all()
    t, tri, steps, rows = tb16.bvh16_walk_reference(tbv.table, o, d, tm, True, 432, 1e-4,
                                                    return_visited=True)
    assert not (tri[masked] >= 0).any() and (steps >= 1).all()
    ms, by = bench_k3.walk_bound(tbv.table, n, rows, steps.sum())
    I = tbv.n_interior
    assert rows[:I].any() and rows[I:].any()
    tb = ((int(rows[:I].sum()) * 384 + int(rows[I:].sum()) * 480 + n * 40)
          / bench_k3.HBM_BYTES_PER_S * 1e3)
    tf = int(steps.sum()) * 432 / bench_k3.FP32_FLOP_PER_S * 1e3
    assert ms == pytest.approx(max(tb, tf)) and by == ("bytes" if tb >= tf else "operations")


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_cuda_k3_matches_plain(cuda_device, any_hit):
    """K3 against its plain walk, capped and uncapped, with masked lanes
    (t_max 1e-4) and a ray count no CTA divides; a second launch gives the
    same bits (rays come from an atomic queue the kernel leaves at zero)."""
    _, _, tbv, o, d, tmax = _setup()
    n = R - 3
    tmax = tmax.copy()
    tmax[::5] = 1e-4
    table = tbv.table.to(cuda_device)
    o, d, tmax = (torch.as_tensor(a[:n]).to(cuda_device) for a in (o, d, tmax))
    for steps in (8, 24, 64, tb16.UNCAPPED_STEPS):
        n0 = tb16.launches
        got = tb16.bvh16_walk(table, o, d, tmax, any_hit, steps)
        again = tb16.bvh16_walk(table, o, d, tmax, any_hit, steps)
        torch.cuda.synchronize()
        assert tb16.launches == n0 + 2
        ref = tb16.bvh16_walk_reference(table, o, d, tmax, any_hit, steps)
        for a, b, c in zip(got, ref, again):
            assert torch.equal(a, b) and torch.equal(a, c)
        assert not (got[1][::5] >= 0).any()
        queue = tb16._queue(o.device, torch.cuda.current_stream(o.device).cuda_stream)
        assert queue.tolist() == [0, 0]
