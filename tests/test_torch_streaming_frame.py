"""The streamed NormalBasic frame of the PyTorch port against the JAX
Renderer on the CPU, at 96x64 with texture streaming in a 2 MB pool (128
pages) and the residency heatmap (tex_debug), 14 frames, on
tests/test_streaming.py's end-to-end scene made wider: two textured floor
planes side by side (256x256 seeded textures, 84 tiles each down to mip 0)
seen from close by, so that the frame demands mip 0 of both and they do
not both fit in the pool. (At 96x64 the stress scene's textures are seen
at mip 3 and coarser, which live in the always-resident tail.)

Both Renderers get a sync-mode streamer with one injected clock in place of
their worker threads (the JAX class's own test hooks), so they stream in
lockstep: each frame renders, the port's streamer is given the JAX frame's
feedback when the JAX Renderer fetches it (every 8th frame), both streamers
poll, and the next frame applies their batches. Checked: the batches equal
at every poll, the streaming tables equal after every apply, the frames
within the stress frames' LDR bounds (test_torch_normal_basic.py), the
stream_* stats equal, and the TexResidencyDebug pass against the JAX
pass's body on the same residency clamp."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hobbyrenderer_tpu.config import Config as JaxConfig
from hobbyrenderer_tpu.renderer import Renderer as JaxRenderer
from hobbyrenderer_tpu.scene import cooker as jcooker
from hobbyrenderer_tpu.scene import procedural as jproc
from hobbyrenderer_tpu.scene import scene as jscene_mod
from hobbyrenderer_tpu.scene import streaming as jstream
from hobbyrenderer_tpu_torch.config import Config
from hobbyrenderer_tpu_torch.scene import cooker as tcooker
from hobbyrenderer_tpu_torch.scene import procedural as tproc
from hobbyrenderer_tpu_torch.scene import scene as tscene_mod
from hobbyrenderer_tpu_torch.models.deferred import tex_residency_overlay
from hobbyrenderer_tpu_torch.renderer import Renderer as TorchRenderer
from hobbyrenderer_tpu_torch.scene import streaming as tstream
from hobbyrenderer_tpu_torch.scene.gpu import stream_tables_from_numpy
from tests.test_torch_streaming import _own, _same_batch
from tests.torch_parity import ldr_agreement, same_mesh_cooker

W, H = 96, 64
FRAMES = 14
TILES_PER_FRAME = 16      # a batch a poll of at most 16 tiles: several applies
LDR_TOL = (0.99, 1.5)     # >= 99% of pixels within 2/255; mean |d| as the stress frames
PASSES = ["Culling", "Raster", "HZBBuild", "RasterPhase2", "ResolveGBuffer", "ShadowCSM", "IBL", "DeferredLighting", "Sky", "TAA", "AutoExposure", "Bloom",
          "Tonemap", "TexResidencyDebug"]


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


def floor_scene(proc, scene_mod, cooker):
    """Two textured floor planes (seeded 256x256 textures) under a sun,
    built with one package's classes."""
    sc = scene_mod.Scene()
    rng = np.random.default_rng(3)
    sc.images = []
    pos, nrm, uv, idx = proc.plane_geometry(2.0, uv_tiles=1.0)
    for k, x in enumerate((-2.0, 2.0)):
        img = rng.integers(0, 256, (256, 256, 4), dtype=np.uint8)
        img[..., 3] = 255
        sc.images.append(img)
        m = sc.add_material(scene_mod.Material(name=f"floor{k}", roughness=0.8,
                                               base_color_tex=k, double_sided=True))
        prim = sc.add_mesh(cooker.cook_mesh(pos, idx, normals=nrm, uvs=uv), material=m)
        sc.add_node(scene_mod.Node(name=f"floor{k}", mesh_primitives=[prim],
                                   translation=np.array([x, 0.0, 0.0], np.float32)))
    sc.add_light(scene_mod.Light(type=scene_mod.LIGHT_DIRECTIONAL,
                                 direction=np.array([0.3, -1.0, 0.2], np.float32),
                                 intensity=3.0))
    sc.cameras.append(proc.camera_looking_at(np.array([0, 1.2, 1.6], np.float32),
                                             np.array([0, 0, 0], np.float32)))
    sc.finalize()
    return sc


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    if _CACHE:
        return _CACHE
    kw = dict(scene="floors", width=W, height=H, mode="normal_basic", tex_streaming=True,
              tex_budget_mb=2, tex_debug=True)
    # a cache directory each: both Renderers' camera-state threads save there
    jr = JaxRenderer(JaxConfig(**kw, cache_dir=str(tmp_path_factory.mktemp("stream_jax"))),
                     scene=floor_scene(jproc, jscene_mod, jcooker))
    tr = TorchRenderer(Config(**kw, cache_dir=str(tmp_path_factory.mktemp("stream_port"))),
                       scene=floor_scene(tproc, tscene_mod, tcooker), device="cpu")
    tr._model.keep = ("tex_clamp",)
    clock = {"t": 0.0}
    for r, mod in ((jr, jstream), (tr, tstream)):
        pages = r.streamer.budget_pages
        r.streamer.stop()
        r.streamer = mod.TextureStreamer(r.scene, budget_pages=pages, sync_mode=True,
                                         tiles_per_frame=TILES_PER_FRAME,
                                         now_fn=lambda: clock["t"])
    ldr, applies, polls, stats, fb_frames = [], 0, 0, [], []
    for f in range(FRAMES):
        pending = jr.streamer._pending is not None
        lj, lt = np.asarray(jr.render_frame()), tr.render_frame().numpy()
        ldr.append((lj, lt))
        if f == 0:
            clamp0 = tr._model.last_resources["tex_clamp"]    # all in the tail
        if pending:
            # the batch applied at this frame's start: the tables match
            want = stream_tables_from_numpy(_own(jr.gpu.tex_stream), "cpu")
            got = tr.gpu.tex_stream
            for k in ("page_table", "mat_resident", "tex_pool", "vt_base", "tail_off"):
                assert torch.equal(getattr(got, k), getattr(want, k)), (f, k)
            applies += 1
        stats.append((jr.stats(), tr.stats()))
        if jr.streamer._feedback is not None:
            fb_frames.append(f)
            fb_j = np.asarray(jr.streamer._feedback)
            fb_t = tr.streamer._feedback
            _CACHE.setdefault("feedback", (fb_j, fb_t))
            tr.streamer.publish_feedback(fb_j.copy())       # the same feedback
        clock["t"] += 1.0 / 60.0
        jr.streamer.poll()
        tr.streamer.poll()
        _same_batch(jr.streamer._pending, tr.streamer._pending, f"poll after frame {f}")
        polls += jr.streamer._pending is not None
    clamp = clamp0
    jr.shutdown()
    tr.shutdown()
    _CACHE.update(jr=jr, tr=tr, ldr=ldr, applies=applies, polls=polls, stats=stats,
                  fb_frames=fb_frames, clamp=clamp)
    return _CACHE


def test_streamed_frames_and_tables_match_jax(lockstep):
    c = lockstep
    assert c["fb_frames"] == [7], c["fb_frames"]
    assert c["applies"] >= 3, c["applies"]       # frames 9, 10, ... apply batches
    for f, (lj, lt) in enumerate(c["ldr"]):
        within, mean_d, _ = ldr_agreement(lj, lt)
        assert within >= LDR_TOL[0] and mean_d <= LDR_TOL[1], (f, within, mean_d)
    enabled = [p.name for p in c["tr"].graph.passes if p.enabled]
    assert enabled == [p.name for p in c["jr"]._model.graph.passes if p.enabled] == PASSES
    # the frame's own feedback: the finest mip each material demands agrees
    fb_j, fb_t = c["feedback"]
    finest = [(np.nonzero(fb_j[m])[0][:1].tolist(), np.nonzero(fb_t[m])[0][:1].tolist())
              for m in range(fb_j.shape[0])]
    assert all(a == b for a, b in finest), finest


def test_stream_stats_match_jax(lockstep):
    keys = ("stream_free_pages", "stream_budget_pages", "stream_resident_mips")
    for f, (sj, st) in enumerate(lockstep["stats"]):
        assert {k: sj[k] for k in keys} == {k: st[k] for k in keys}, f
        assert st["tex_feedback_host_syncs"] == (f + 1) // 8
    last = lockstep["stats"][-1][1]
    # every applied batch took TILES_PER_FRAME pages of the 128
    assert last["stream_budget_pages"] == 128
    assert last["stream_free_pages"] == 128 - TILES_PER_FRAME * lockstep["applies"]
    # both textured materials left the tail (mip 3 of a 256^2 texture)
    assert max(last["stream_resident_mips"][1:]) < 3, last["stream_resident_mips"]


def test_tex_residency_overlay_matches_jax_pass(lockstep):
    """The port's TexResidencyDebug body against the JAX graph's pass
    function on the port's last residency clamp and a seeded frame."""
    clamp = lockstep["clamp"]
    assert float(clamp.max()) > 0.0, "no pixel was clamped"
    ldr = np.random.default_rng(3).integers(0, 256, (H, W, 3)).astype(np.uint8)
    res = {"ldr": jnp.asarray(ldr), "tex_clamp": jnp.asarray(clamp.numpy())}
    lockstep["jr"]._model.graph.get("TexResidencyDebug").fn(None, res)
    want = np.asarray(res["ldr"]).astype(np.int32)
    got = tex_residency_overlay(torch.as_tensor(ldr), clamp).numpy()
    assert got.dtype == np.uint8
    assert np.abs(got.astype(np.int32) - want).max() <= 1
