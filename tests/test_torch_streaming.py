"""Texture streaming in the PyTorch port against the JAX package on the CPU.

- The port's TextureStreamer (scene/streaming.py) against the JAX one in
  sync mode, on the same scene, under the same scripted feedback and the
  same injected clock: every upload batch (pool rows, texels, page entries,
  resident mips, freed pages) equal, and the streaming tables equal after
  every apply (the JAX tables carried across with stream_tables_from_numpy).
  The scripts are those of tests/test_streaming.py: convergence to mip 0,
  the per-frame tile budget, eviction after the hysteresis window, LRU
  reuse under a small pool, and churn (random demands, downgrades and
  recycling interleaved).
- sample_material_streamed and texture_feedback (ops/texture.py) on seeded
  inputs through the same tables: the decoded texels within 1e-6 (the sRGB
  power may differ by an ulp), the histogram exactly.

On the CPU backend jnp.asarray of a numpy array can share its memory (when
the buffer happens to be aligned), so the JAX streamer's page table and
resident mips, made from its host mirrors by jnp.asarray, can follow later
edits of those mirrors (LRU evictions) before the next apply replaces them.
The JAX tables are therefore copied right after each initial_tables /
apply_updates (``_own``): the state at that moment, which the port's
tables hold."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hobbyrenderer_tpu.ops import texture as jtex
from hobbyrenderer_tpu.scene import procedural as jproc
from hobbyrenderer_tpu.scene import scene as jscene_mod
from hobbyrenderer_tpu.scene import streaming as jstream
from hobbyrenderer_tpu_torch.ops import texture as ttex
from hobbyrenderer_tpu_torch.scene import procedural as tproc
from hobbyrenderer_tpu_torch.scene import scene as tscene_mod
from hobbyrenderer_tpu_torch.scene import streaming as tstream
from hobbyrenderer_tpu_torch.scene.gpu import stream_tables_from_numpy
from hobbyrenderer_tpu_torch.scene.textures import MAX_MIPS
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


def _textured_scene(proc, scene_mod, res=256, n_mats=2, seed=0):
    """tests/test_streaming.py's scene, built with one package's classes:
    the cube plus ``n_mats`` materials, each with a seeded random texture."""
    sc = proc.make_default_cube_scene()
    rng = np.random.default_rng(seed)
    sc.images = []
    for k in range(n_mats):
        img = rng.integers(0, 256, (res, res, 4), dtype=np.uint8)
        img[..., 3] = 255
        sc.images.append(img)
        sc.materials.append(scene_mod.Material(name=f"tex{k}",
                                               base_color_tex=len(sc.images) - 1))
    return sc


def _feedback(n_mats, demands):
    fb = np.zeros((n_mats, MAX_MIPS), np.int32)
    for mi, li in demands.items():
        fb[mi, li] = 100
    return fb


def _pair(n_mats, **kw):
    """A JAX and a port streamer in sync mode on the same scene, each with
    its own copy of one injected clock."""
    clock = {"t": 0.0}
    js = jstream.TextureStreamer(_textured_scene(jproc, jscene_mod, n_mats=n_mats),
                                 sync_mode=True, now_fn=lambda: clock["t"], **kw)
    ts = tstream.TextureStreamer(_textured_scene(tproc, tscene_mod, n_mats=n_mats),
                                 sync_mode=True, now_fn=lambda: clock["t"], **kw)
    return clock, js, ts


def _own(jt):
    """The JAX tables with their arrays copied out of any numpy memory."""
    return jt._replace(**{k: jnp.array(np.array(getattr(jt, k)))
                          for k in ("page_table", "mat_resident", "tex_pool")})


def _same_tables(jt, tt, what):
    want = stream_tables_from_numpy(jt, "cpu")
    for k in tstream.StreamTables._fields:
        a, b = getattr(tt, k), getattr(want, k)
        if k == "pool_base":
            assert a == b, what
        else:
            assert a.dtype == torch.int64, (what, k)
            assert torch.equal(a, b), (what, k)


def _same_batch(jb, tb, what):
    assert (jb is None) == (tb is None), what
    if jb is None:
        return
    for k in ("rows", "texels", "page_entries", "resident"):
        a, b = getattr(tb, k), getattr(jb, k)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")
    assert tb.freed == jb.freed, what


def _converge(M, mi):
    return [(0.0, {mi: 0})] * 8


def _budget(M, mi):
    return [(0.0, {mi: 0})]


def _eviction(M, mi):
    return [(0.0, {mi: 0})] * 6 + [(0.5, {mi: 3}), (2.2, {mi: 3}), (0.1, {mi: 3})]


def _pressure(M, mi):
    return [(0.0, {m: 1 for m in (M - 3, M - 2, M - 1)})] * 12


def _churn(M, mi):
    rng = np.random.default_rng(9)
    steps = []
    for _ in range(40):
        steps.append((0.3, {m: int(rng.integers(0, 4)) for m in (M - 3, M - 2, M - 1)
                            if rng.random() < 0.8}))
    return steps


# (script, materials, streamer options): tests/test_streaming.py:38, 74, 87,
# 121 and 209
SCRIPTS = {
    "converge": (_converge, 2, dict(budget_pages=256, tiles_per_frame=16, hysteresis_s=0.0)),
    "budget": (_budget, 2, dict(budget_pages=256, tiles_per_frame=8, hysteresis_s=0.0)),
    "eviction": (_eviction, 2, dict(budget_pages=256, tiles_per_frame=128,
                                    hysteresis_s=2.0)),
    "pressure": (_pressure, 3, dict(budget_pages=40, tiles_per_frame=16, hysteresis_s=0.0)),
    "churn": (_churn, 3, dict(budget_pages=48, tiles_per_frame=5, hysteresis_s=0.5)),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_streamer_batches_and_tables_match_jax(name):
    """Both streamers step through the script: publish, poll, compare the
    pending batch, apply, compare the tables (and the host mirrors)."""
    script, n_mats, kw = SCRIPTS[name]
    clock, js, ts = _pair(n_mats, **kw)
    M = js.n_mats
    assert ts.n_mats == M and ts.pool_base == js.pool_base
    np.testing.assert_array_equal(ts.tail_texels, js.tail_texels)
    np.testing.assert_array_equal(ts.vt_base, js.vt_base)
    jt, tt = _own(js.initial_tables()), ts.initial_tables("cpu")
    _same_tables(jt, tt, "initial")
    applied = freed = 0
    for i, (dt, demands) in enumerate(script(M, M - 2)):
        clock["t"] += dt
        fb = _feedback(M, demands)
        js.publish_feedback(fb)
        ts.publish_feedback(fb.copy())
        js.poll()
        ts.poll()
        _same_batch(js._pending, ts._pending, f"{name} step {i}")
        applied += js._pending is not None
        freed += bool(js._pending is not None and js._pending.freed)
        jt, tt = _own(js.apply_updates(jt)), ts.apply_updates(tt)
        _same_tables(jt, tt, f"{name} step {i}")
        np.testing.assert_array_equal(ts.page_table, js.page_table)
        assert ts.free_pages == js.free_pages and ts.desired.tolist() == js.desired.tolist()
    assert applied, "the script applied no batch"
    if name in ("eviction", "churn"):
        # a batch that freed pages re-uploaded the whole host page table
        assert freed, "the script freed no page"
    js.stop()
    ts.stop()


@pytest.fixture(scope="module")
def converged():
    """Both streamers after the pressure script: three materials, some
    mips paged, some in the tail, the tables carried across."""
    script, n_mats, kw = SCRIPTS["pressure"]
    _, js, ts = _pair(n_mats, **kw)
    jt, tt = _own(js.initial_tables()), ts.initial_tables("cpu")
    for _, demands in script(js.n_mats, 0):
        for s_ in (js, ts):
            s_.publish_feedback(_feedback(js.n_mats, demands))
            s_.poll()
        jt, tt = _own(js.apply_updates(jt)), ts.apply_updates(tt)
    _same_tables(jt, tt, "converged")
    return js, jt, tt


def test_sample_material_streamed_matches_jax(converged):
    js, jt, tt = converged
    M = js.n_mats
    rng = np.random.default_rng(5)
    n = 4096
    mat = rng.integers(-1, M + 1, n).astype(np.int32)
    uv = rng.uniform(-2.0, 3.0, (n, 2)).astype(np.float32)
    lod = rng.uniform(-2.0, 9.0, n).astype(np.float32)
    key = rng.integers(0, 2 ** 32, (n, 3), dtype=np.uint64).astype(np.uint32)
    want = jtex.sample_material_streamed(jt, jnp.asarray(mat), jnp.asarray(uv),
                                         jnp.asarray(lod), jnp.asarray(key))
    got = ttex.sample_material_streamed(tt, torch.as_tensor(mat.astype(np.int64)),
                                        torch.as_tensor(uv), torch.as_tensor(lod),
                                        torch.as_tensor(key.astype(np.int64)))
    resident = np.asarray(jt.mat_resident)
    assert (resident[M - 3:] < 3).any() and (resident[M - 3:] == 3).any(), resident
    for k, a in got._asdict().items():
        np.testing.assert_allclose(a.numpy(), np.asarray(getattr(want, k)), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_texture_feedback_matches_jax():
    rng = np.random.default_rng(6)
    H, W, M = 61, 83, 7
    mat = rng.integers(-1, M + 1, (H, W)).astype(np.int32)
    lod = rng.uniform(-3.0, 14.0, (H, W)).astype(np.float32)
    want = np.asarray(jtex.texture_feedback(jnp.asarray(mat), jnp.asarray(lod), M))
    got = ttex.texture_feedback(torch.as_tensor(mat.astype(np.int64)), torch.as_tensor(lod), M)
    assert got.dtype == torch.int64 and tuple(got.shape) == want.shape == (M, MAX_MIPS)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == len(range(0, H, 4)) * len(range(0, W, 4))


def test_trace_paths_streamed_matches_jax():
    """The path tracer's hits sample through the streaming tables: the
    two-floor scene of tests/test_torch_streaming_frame.py with one
    material streamed to mip 1 and the other to mip 0 (its mip 0 still
    loading in places), carried across, 32x32 at 3 bounces; the gate of
    tests/test_torch_pathtracer.py."""
    import dataclasses
    import jax
    from hobbyrenderer_tpu.config import RenderSettings as JaxRenderSettings
    from hobbyrenderer_tpu.models import pathtracer as jpt
    from hobbyrenderer_tpu.scene import cooker as jcooker
    from hobbyrenderer_tpu.scene.gpu import build_scene_gpu as jax_build_scene_gpu
    from hobbyrenderer_tpu_torch.config import Config
    from hobbyrenderer_tpu_torch.models import pathtracer as tpt
    from hobbyrenderer_tpu_torch.models import scene_rt as tsrt
    from hobbyrenderer_tpu_torch.renderer import device_view_constants
    from hobbyrenderer_tpu_torch.scene.gpu import scene_gpu_from_numpy
    from tests.test_torch_pathtracer import _gate, _view
    from tests.test_torch_streaming_frame import floor_scene

    W = H = 32
    scene = floor_scene(jproc, jscene_mod, jcooker)
    js = jstream.TextureStreamer(scene, budget_pages=128, tiles_per_frame=16, sync_mode=True)
    jg = jax_build_scene_gpu(scene, streamer=js, max_lights=max(64, len(scene.lights) + 8))
    tables = _own(jg.tex_stream)
    for _ in range(4):
        js.publish_feedback(_feedback(js.n_mats, {1: 1, 2: 0}))
        js.poll()
        tables = _own(js.apply_updates(tables))
    js.stop()
    res = np.asarray(tables.mat_resident)
    assert res[1] == 1 and res[2] == 1 and (np.asarray(tables.page_table) >= 0).sum() > 40, res
    jg = dataclasses.replace(jg, tex_stream=tables)
    jrt = jpt.build_scene_rt(scene, jg)
    leaves = {k: np.asarray(getattr(jg, k)) for k in jg.__dataclass_fields__
              if getattr(jg, k) is not None and k != "tex_stream"}
    tg = scene_gpu_from_numpy(dict(leaves, tex_stream=tables), "cpu")
    d = {k: np.asarray(getattr(jrt, k)) for k in tsrt.RT_FIELDS + tsrt.TABLE_FIELDS}
    d["bvh16"] = {k: np.asarray(getattr(jrt.bvh16, k))
                  for k in ("table", "order", "root_box", "recs", "slot_of")}
    d["lights"] = {k: np.asarray(getattr(jrt.lights, k))
                   for k in ("n_analytic", "n_total") + tsrt.POOL_FIELDS}
    d["em_index"] = np.asarray(jrt.em_index)
    trt = tsrt.scene_rt_from_numpy(d, "cpu")
    vc = _view(scene, W, H)
    want = jax.jit(lambda g, rt, v: jpt.trace_paths(
        g, rt, v, JaxRenderSettings().as_pytree(), H, W, 3, max_bounces=3))(jg, jrt, vc)
    got = tpt.trace_paths(tg, trt, device_view_constants(vc, "cpu"), Config().settings, H, W,
                          3, max_bounces=3)
    _gate(np.asarray(want), got.numpy())
