"""Rank bodies of the port's multi-GPU tests (tests/test_torch_shard_utils.py,
tests/test_torch_parallel_*.py), and the set-up they share with the tests'
single-device references. The ranks start with ``spawn`` and import the
module of their body: this one imports neither jax nor the JAX package.
Every body runs on CPU ranks (gloo), with one torch thread a rank, and
returns numpy arrays (parallel/launch.py::run_ranks)."""

import numpy as np
import torch

from hobbyrenderer_tpu_torch.config import RenderSettings
from hobbyrenderer_tpu_torch.models.scene_rt import build_scene_rt
from hobbyrenderer_tpu_torch.ops import culling as cullops
from hobbyrenderer_tpu_torch.ops import denoise as dnops
from hobbyrenderer_tpu_torch.ops import ibl as iblops
from hobbyrenderer_tpu_torch.ops import post as postops
from hobbyrenderer_tpu_torch.ops import raster as rasterops
from hobbyrenderer_tpu_torch.ops import restir as restirops
from hobbyrenderer_tpu_torch.ops import shard_utils as shu
from hobbyrenderer_tpu_torch.ops import sky as skyops
from hobbyrenderer_tpu_torch.ops import specular as specops
from hobbyrenderer_tpu_torch.ops import ssgi as ssgiops
from hobbyrenderer_tpu_torch.ops import taa as taaops
from hobbyrenderer_tpu_torch.ops import transparent as transops
from hobbyrenderer_tpu_torch.parallel.frame import sun_dir
from hobbyrenderer_tpu_torch.renderer import device_view_constants
from hobbyrenderer_tpu_torch.scene.camera import Camera
from hobbyrenderer_tpu_torch.scene.gpu import build_scene_gpu
from hobbyrenderer_tpu_torch.scene.procedural import make_default_cube_scene, make_stress_scene

DEV = torch.device("cpu")


def make_scene(name: str):
    """"cube", "stress:N" or "floor" (a textured plane; see floor_scene)."""
    if name == "cube":
        return make_default_cube_scene()
    if name == "floor":
        return floor_scene()
    return make_stress_scene(grid=int(name.split(":")[1]))


def floor_scene():
    """tests/test_parallel.py's streaming scene: one 256x256 seeded texture
    on a 4-unit plane under a camera at (0, 3, 3)."""
    from hobbyrenderer_tpu_torch.scene.cooker import cook_mesh
    from hobbyrenderer_tpu_torch.scene.procedural import camera_looking_at, plane_geometry
    from hobbyrenderer_tpu_torch.scene.scene import Material, Node, Scene
    sc = Scene()
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (256, 256, 4), dtype=np.uint8)
    img[..., 3] = 255
    sc.images = [img]
    m = sc.add_material(Material(name="floor", roughness=0.8, base_color_tex=0,
                                 double_sided=True))
    pos, nrm, uv, idx = plane_geometry(4.0, uv_tiles=1.0)
    prim = sc.add_mesh(cook_mesh(pos, idx, normals=nrm, uvs=uv), material=m)
    sc.add_node(Node(name="floor", mesh_primitives=[prim]))
    sc.cameras.append(camera_looking_at(np.array([0, 3.0, 3.0], np.float32),
                                        np.array([0, 0, 0], np.float32)))
    sc.finalize()
    return sc


def setup(name: str, W: int, H: int, rt: bool = False, streaming: bool = False):
    """(gpu, rt or None, camera without jitter, settings) of scene ``name``
    at W x H on the CPU, as tests/test_parallel.py builds them."""
    sc = make_scene(name)
    streamer = None
    if streaming:
        from hobbyrenderer_tpu_torch.scene.streaming import TextureStreamer
        streamer = TextureStreamer(sc, budget_pages=64, sync_mode=True)
    gpu = build_scene_gpu(sc, DEV, streamer=streamer)
    cam = Camera(sc.cameras[0], W, H)
    cam.jitter_enabled = False
    return gpu, (build_scene_rt(sc, DEV, gpu=gpu) if rt else None), cam, RenderSettings()


def vc_of(cam, i: int = 0):
    return device_view_constants(cam.view_constants(i), DEV)


def opaque_gbuffer(gpu, vc, W: int, H: int, y0: int = 0, shard_h: int = None,
                   want_feedback: bool = False):
    """Culling, the (band) raster and the G-buffer resolve."""
    cu = cullops.cull_pairs(gpu, vc, alpha_mask=(True, True, False))
    slots, _ = cullops.compact_mask(cu["mask"], max(int(gpu.lod0_pair_capacity), 1))
    ro, attr = rasterops.rasterize(gpu, vc, slots, W, H, y0=y0, shard_height=shard_h)
    return rasterops.resolve_gbuffer(gpu, vc, ro, attr, y0=y0, want_feedback=want_feedback)


def band(x, shard):
    """The rows of a whole-frame array (or each field of a NamedTuple) that
    make ``shard``'s band."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return type(x)(*[band(f, shard) for f in x])
    return x[shard.y0:shard.y0 + shard.shard_h]


# ---- shard_utils ------------------------------------------------------------

def extend_body(mesh, full, halos, gy):
    """extend_rows of this rank's band of ``full`` for each halo, and
    ext_row_index of the global rows ``gy``."""
    h = full.shape[0] // mesh.n
    sh = shu.make_row_shard(mesh, h)
    x = torch.as_tensor(full[mesh.rank * h:(mesh.rank + 1) * h])
    return {"ext": [shu.extend_rows(x, halo, sh) for halo in halos],
            "idx": [shu.ext_row_index(torch.as_tensor(gy), halo, sh, h) for halo in halos]}


def raster_body(mesh, vc, W: int, H: int, slots):
    """stress:2's band raster of ``slots`` under the view constants ``vc``
    (numpy, Camera.view_constants): depth, visid, attribute planes, and the
    arguments of its K1 call."""
    from hobbyrenderer_tpu_torch.ops import raster_kernel as rk
    gpu = build_scene_gpu(make_scene("stress:2"), DEV)
    h = H // mesh.n
    calls = []
    orig = rk.raster_resolve_tiles

    def spy(records, work_tile, work_slot, **kw):
        calls.append(kw)
        return orig(records, work_tile, work_slot, **kw)
    rk.raster_resolve_tiles = spy
    try:
        ro, attr = rasterops.rasterize(gpu, device_view_constants(vc, DEV),
                                       torch.as_tensor(slots), W, H, y0=mesh.rank * h,
                                       shard_height=h)
    finally:
        rk.raster_resolve_tiles = orig
    return {"depth": ro.depth, "visid": ro.visid, "attr": attr, "k1": calls[0]}


# ---- the sharded ops against the single-device ops -------------------------

def restir_chain(gpu, vc, settings, gb, prev, dn, hist, shard=None):
    """tests/test_parallel.py's restir + denoise + TAA chain (frame 3, no
    visibility)."""
    d, r = restirops.restir_di(gpu, None, gb, vc, settings, prev, 3, visibility=False,
                               shard=shard)
    d, dn2 = dnops.denoise(d, gb, dn, shard=shard)
    out = taaops.taa_resolve(d, hist, gb.motion, True, settings, shard=shard)
    return out, r, dn2


def restir_inputs(W: int = 64, H: int = 64):
    gpu, _, cam, settings = setup("cube", W, H)
    vc = vc_of(cam)
    gb = opaque_gbuffer(gpu, vc, W, H)
    return (gpu, vc, settings, gb, restirops.reservoir_init(H, W, DEV),
            dnops.denoise_init(H, W, DEV), torch.zeros((H, W, 3)))


def transparent_inputs(W: int = 64, H: int = 64):
    """stress:4 (BLEND materials) with a synthetic lit frame, so that the
    refraction's fetches matter."""
    gpu, _, cam, settings = setup("stress:4", W, H)
    vc = vc_of(cam)
    gb = opaque_gbuffer(gpu, vc, W, H)
    yy, xx = torch.meshgrid(torch.linspace(0, 1, H), torch.linspace(0, 1, W), indexing="ij")
    hdr = torch.stack([xx, yy, 1.0 - xx], -1)
    sun = sun_dir(gpu, settings)
    kw = dict(width=W, height=H, transparent_capacity=max(int(gpu.lod0_pair_capacity), 1),
              sun_dir=sun, sky_sh=iblops.build_sky_irradiance(sun, settings), ibl_scale=1.0)
    return gpu, vc, settings, gb, hdr, kw


def specular_inputs(W: int = 64, H: int = 64):
    gpu, rt, cam, settings = setup("cube", W, H, rt=True)
    vc = vc_of(cam)
    gb = opaque_gbuffer(gpu, vc, W, H)
    sun = sun_dir(gpu, settings)
    kw = dict(sun_dir=sun, skip_pool_emissive=True,
              sky_sh=iblops.build_sky_irradiance(sun, settings), ibl_scale=1.0)
    return gpu, rt, vc, settings, gb, specops.spec_state_init(H, W, DEV), kw


DEEP_BLOOM = (1088, 128)     # 2 bands of 544 rows: 17-row bands at level 5


def bloom_input(H: int = 128, W: int = 64):
    rng = np.random.default_rng(11)
    return torch.as_tensor(rng.random((H, W, 3), np.float32) * 3.0), RenderSettings()


def ssgi_inputs(W: int = 64, H: int = 64):
    """The cube at 64x64 with a seeded previous frame to march against."""
    gpu, _, cam, settings = setup("cube", W, H)
    vc = vc_of(cam)
    gb = opaque_gbuffer(gpu, vc, W, H)
    prev = torch.as_tensor(np.random.default_rng(4).random((H, W, 3), np.float32))
    sun = sun_dir(gpu, settings)
    return gpu, vc, settings, gb, prev, iblops.build_sky_irradiance(sun, settings)


def indirect_inputs(W: int = 64, H: int = 64):
    """The cube at 64x64 with its ray-tracing scene (SHARC, DDGI)."""
    gpu, rt, cam, settings = setup("cube", W, H, rt=True)
    vc = vc_of(cam)
    gb = opaque_gbuffer(gpu, vc, W, H)
    sun = sun_dir(gpu, settings)
    return gpu, rt, vc, settings, gb, iblops.build_sky_irradiance(sun, settings)


def sharc_two_frames(gpu, rt, vc, settings, gb, irr, shard=None):
    """Two frames of the combined SHARC band (the second reads a populated
    cache): (indirect, cache)."""
    from hobbyrenderer_tpu_torch.ops.sharc import sharc_init
    from hobbyrenderer_tpu_torch.parallel.flagship import sharc_indirect_band
    h, W = gb.depth.shape
    cache, q = sharc_init(DEV), dnops.denoise_init(h // 2, W // 2, DEV)
    for _ in range(2):
        ind, cache, q = sharc_indirect_band(gpu, rt, gb, vc, settings, cache, q, irr, shard)
    return ind, cache


def ddgi_two_frames(gpu, rt, vc, settings, gb, shard=None):
    """Two frames of the DDGI band (the second queries a populated,
    classified volume): (indirect, volume)."""
    from hobbyrenderer_tpu_torch.ops.ddgi import ddgi_init
    from hobbyrenderer_tpu_torch.parallel.flagship import ddgi_indirect_band
    vol = ddgi_init(*gpu.meta["scene_bounds"], DEV)
    for _ in range(2):
        ind, vol = ddgi_indirect_band(gpu, rt, gb, vc, settings, vol, shard)
    return ind, vol


def feedback(gpu, vc, W: int, H: int, y0: int = 0, shard_h: int = None):
    return opaque_gbuffer(gpu, vc, W, H, y0=y0, shard_h=shard_h, want_feedback=True)[1]


def ops_body(mesh):
    """Every sharded op of tests/test_torch_parallel_ops.py on this rank's
    band; each result gathered to the whole frame."""
    out = {}
    rows = mesh.all_gather_rows

    gpu, vc, settings, gb, prev, dn, hist = restir_inputs()
    sh = shu.make_row_shard(mesh, gb.depth.shape[0] // mesh.n)
    img, res, dn2 = restir_chain(gpu, vc, settings, band(gb, sh), band(prev, sh),
                                 band(dn, sh), band(hist, sh), shard=sh)
    out["restir"] = [rows(img)] + [rows(f) for f in res] + [rows(f) for f in dn2]

    hdr, settings = bloom_input()
    sh = shu.make_row_shard(mesh, hdr.shape[0] // mesh.n)
    out["bloom"] = rows(postops.bloom_sharded(band(hdr, sh), settings, sh,
                                              full_h=hdr.shape[0]))
    hdr, settings = bloom_input(*DEEP_BLOOM)
    sh = shu.make_row_shard(mesh, hdr.shape[0] // mesh.n)
    out["bloom_deep"] = rows(postops.bloom_sharded(band(hdr, sh), settings, sh,
                                                   full_h=hdr.shape[0]))

    gpu, vc, settings, gb, hdr, kw = transparent_inputs()
    sh = shu.make_row_shard(mesh, hdr.shape[0] // mesh.n)
    out["transparent"] = rows(transops.transparent_composite(
        gpu, vc, settings, band(gb, sh), band(hdr, sh), y0=sh.y0, shard_h=sh.shard_h,
        hdr_full=hdr, **kw))

    gpu, rt, vc, settings, gb, st0, kw = specular_inputs()
    sh = shu.make_row_shard(mesh, gb.depth.shape[0] // mesh.n)
    sub = shu.sub_shard(sh, 2, sh.shard_h // 2)
    spec, w, st = specops.specular_indirect(gpu, rt, band(gb, sh), vc, settings,
                                            band(st0, sub), 2, shard=sh, **kw)
    out["specular"] = [rows(spec), rows(w)] + [rows(f) for f in st]

    gpu, vc, settings, gb, prev, irr = ssgi_inputs()
    sh = shu.make_row_shard(mesh, gb.depth.shape[0] // mesh.n)
    out["ssgi"] = rows(ssgiops.ssgi_half_res(band(gb, sh), vc, None, 5, shard=sh,
                                             depth_full=gb.depth, prev_hdr_full=prev))

    gpu, rt, vc, settings, gb, irr = indirect_inputs()
    sh = shu.make_row_shard(mesh, gb.depth.shape[0] // mesh.n)
    ind, cache = sharc_two_frames(gpu, rt, vc, settings, band(gb, sh), irr, sh)
    out["sharc"] = [rows(ind)] + list(cache)
    ind, vol = ddgi_two_frames(gpu, rt, vc, settings, band(gb, sh), sh)
    out["ddgi"] = [rows(ind)] + [f for f in vol if isinstance(f, torch.Tensor)]

    W = H = 64
    gpu, _, cam, _ = setup("floor", W, H, streaming=True)
    fb = feedback(gpu, vc_of(cam), W, H, y0=mesh.rank * (H // mesh.n), shard_h=H // mesh.n)
    out["feedback"] = mesh.psum_int(fb)
    return out


# ---- the sharded frames ----------------------------------------------------

def deferred_body(mesh, W: int, H: int):
    """DeferredShardedRenderer's frame of the cube scene, the sky marched at
    full resolution (SKY_FAST_SCALE = 1, as the single-device reference)."""
    from hobbyrenderer_tpu_torch.parallel import DeferredShardedRenderer
    skyops.SKY_FAST_SCALE = 1
    gpu, _, cam, settings = setup("cube", W, H)
    return DeferredShardedRenderer(gpu, W, H, mesh=mesh).render(gpu, vc_of(cam), settings)


def pt_body(mesh, W: int, H: int, calls: int):
    """PathTracerShardedRenderer's accumulation after each of ``calls``
    calls on the cube scene."""
    from hobbyrenderer_tpu_torch.config import Config
    from hobbyrenderer_tpu_torch.parallel import PathTracerShardedRenderer
    gpu, rt, cam, settings = setup("cube", W, H, rt=True)
    vc = vc_of(cam)
    vp = cam.view_constants(0)["view_proj_no_jitter"]
    r = PathTracerShardedRenderer(gpu, W, H, rt=rt, mesh=mesh, config=Config())
    acc = []
    for _ in range(calls):
        r.render(gpu, vc, settings, 1 / 60, vp)
        acc.append(r.accum.clone())
    return acc


def failing_body(mesh):
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if mesh.rank == 1:
        raise ValueError("boom")
    return mesh.all_gather(torch.ones(2))
