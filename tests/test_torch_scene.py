"""Scene tables of the PyTorch port against the JAX package: the port's own
copies of the host modules (procedural scenes, Config) against the
originals; the uploaded SceneGPU leaf for leaf, the BVH node table and the
beam table, exactly; and the port's import graph (neither jax nor the JAX
package) in a fresh interpreter."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.models import pathtracer as jpt
from hobbyrenderer_tpu.ops import beam as jbeam
from hobbyrenderer_tpu.ops import bvh as jbvh
from hobbyrenderer_tpu import config as jconfig
from hobbyrenderer_tpu.scene import make_default_cube_scene, make_stress_scene
from hobbyrenderer_tpu.scene.gpu import build_scene_gpu as jax_build_scene_gpu
from hobbyrenderer_tpu_torch import config as tconfig
from hobbyrenderer_tpu_torch.models import scene_rt as tsrt
from hobbyrenderer_tpu_torch.ops import beam as tbeam
from hobbyrenderer_tpu_torch.ops import bvh as tbvh
from hobbyrenderer_tpu_torch.scene import gpu as tgpu
from hobbyrenderer_tpu_torch.scene import procedural as tproc
from tests.torch_parity import same_mesh_cooker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = {"cube": make_default_cube_scene, "stress:2": lambda: make_stress_scene(grid=2)}
TSCENES = {"cube": tproc.make_default_cube_scene,
           "stress:2": lambda: tproc.make_stress_scene(grid=2)}


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


def _same(a, b, what):
    """Recursive equality of scene objects: arrays exactly, dataclasses and
    containers field by field."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _same(a[k], b[k], f"{what}[{k!r}]")
    else:
        assert a == b, (what, a, b)


@pytest.mark.parametrize("name", list(SCENES))
def test_host_module_copies_match_jax_package(name):
    """The port's copies of scene/ and config.py build the same scenes
    (meshes with their LODs and meshlets, materials, lights, nodes,
    instances) and the same Config defaults as the JAX package's."""
    want, got = SCENES[name](), TSCENES[name]()
    for field in ("meshes", "materials", "lights", "nodes", "instances", "cameras",
                  "images"):
        _same(getattr(got, field), getattr(want, field), field)
    for cls in ("Config", "RenderSettings"):
        fj = dataclasses.fields(getattr(jconfig, cls))
        ft = dataclasses.fields(getattr(tconfig, cls))
        assert [f.name for f in ft] == [f.name for f in fj], cls
    _same(dataclasses.asdict(tconfig.Config()), dataclasses.asdict(jconfig.Config()), "Config")
    assert tconfig.RenderingMode.ALL == jconfig.RenderingMode.ALL


def _jax_leaves(g):
    return {f.name: np.asarray(getattr(g, f.name)) for f in dataclasses.fields(g)
            if getattr(g, f.name) is not None}


@pytest.mark.parametrize("name", list(SCENES))
def test_build_scene_gpu_matches_jax(name):
    scene, tscene = SCENES[name](), TSCENES[name]()
    want = _jax_leaves(jax_build_scene_gpu(scene, max_lights=max(64, len(scene.lights) + 8)))
    got = tgpu.build_scene_gpu(tscene, "cpu", max_lights=max(64, len(scene.lights) + 8))
    assert set(tgpu.FIELDS) == set(want)
    for k in tgpu.FIELDS:
        a = getattr(got, k).numpy()
        assert a.shape == want[k].shape, k
        if want[k].dtype.kind == "f":
            assert a.dtype == np.float32, k
            np.testing.assert_array_equal(a.view(np.uint32), want[k].view(np.uint32), err_msg=k)
        else:
            np.testing.assert_array_equal(a, want[k].astype(np.int64), err_msg=k)


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_gpu_from_numpy_roundtrip(name):
    leaves = _jax_leaves(jax_build_scene_gpu(SCENES[name]()))
    got = tgpu.scene_gpu_from_numpy(leaves, "cpu")
    ref = tgpu.build_scene_gpu(TSCENES[name](), "cpu")
    for k in tgpu.FIELDS:
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
    assert got.meta["light_count"] == int(leaves["light_count"])
    assert got.lod0_pair_capacity == int(np.sum(leaves["pair_lod"] == 0))
    # a carried streaming state (the JAX streamer's tables at start) gives
    # the port streamer's tables
    from hobbyrenderer_tpu.scene.streaming import TextureStreamer as JaxStreamer
    from hobbyrenderer_tpu_torch.scene.streaming import StreamTables, TextureStreamer
    js, ts = JaxStreamer(SCENES[name](), sync_mode=True), TextureStreamer(TSCENES[name](),
                                                                          sync_mode=True)
    carried = tgpu.scene_gpu_from_numpy(dict(leaves, tex_stream=js.initial_tables()),
                                        "cpu").tex_stream
    own = ts.initial_tables("cpu")
    for k in StreamTables._fields:
        a, b = getattr(carried, k), getattr(own, k)
        assert (a == b) if k == "pool_base" else torch.equal(a, b), k
    env = tgpu.scene_gpu_from_numpy(dict(leaves, env_sh=np.ones((9, 3), np.float32)), "cpu")
    assert torch.equal(env.env_sh, torch.ones(9, 3)) and env.env_map is None


@pytest.mark.parametrize("name", list(SCENES))
def test_bvh_and_beam_table_match_jax(name):
    rt = tsrt.build_scene_rt(TSCENES[name](), "cpu")
    verts = rt.split_world0.numpy()
    want = jbvh.build_bvh(verts, device_put=False)
    got = tbvh.build_bvh(verts)
    for k in ("table", "order", "root_box"):
        np.testing.assert_array_equal(getattr(got, k), np.asarray(getattr(want, k)), err_msg=k)
    assert got.num_tris == want.num_tris
    bt_want = jbeam.beam_table(np.asarray(want.table))
    np.testing.assert_array_equal(tbeam.beam_table(got.table), bt_want)
    np.testing.assert_array_equal(rt.btable.numpy(), bt_want)


def test_scene_rt_matches_jax_sunshadow_subset():
    scene = make_stress_scene(grid=2)
    jg = jax_build_scene_gpu(scene)
    jrt = jpt.build_scene_rt(scene, jg)
    d = {k: np.asarray(getattr(jrt, k)) for k in tsrt.RT_FIELDS + tsrt.TABLE_FIELDS}
    d.update(bvh_table=np.asarray(jrt.bvh.table), bvh_order=np.asarray(jrt.bvh.order),
             bvh_root_box=np.asarray(jrt.bvh.root_box))
    conv = tsrt.scene_rt_from_numpy(d, "cpu")
    own = tsrt.build_scene_rt(tproc.make_stress_scene(grid=2), "cpu")
    for k in tsrt.RT_FIELDS + tsrt.TABLE_FIELDS:
        assert torch.equal(getattr(conv, k), getattr(own, k)), k
    np.testing.assert_array_equal(conv.bvh.table, own.bvh.table)


def test_port_imports_no_jax(tmp_path):
    """Importing the port and rendering one CPU restir frame and one
    path-tracer frame leaves jax and the JAX package out of sys.modules (a
    fresh interpreter: this test process has both loaded)."""
    code = (
        "import sys\n"
        "import hobbyrenderer_tpu_torch\n"
        "from hobbyrenderer_tpu_torch.config import Config\n"
        "from hobbyrenderer_tpu_torch.renderer import Renderer\n"
        f"r = Renderer(Config(scene='cube', width=64, height=48, direct_mode='restir',"
        f" cache_dir={str(tmp_path)!r}), device='cpu')\n"
        "ldr = r.render_frame()\n"
        "r.shutdown()\n"
        "assert tuple(ldr.shape) == (48, 64, 3), ldr.shape\n"
        "assert r.graph.get('RTXDI').enabled and r.graph.get('Denoise').enabled\n"
        f"p = Renderer(Config(scene='cube', width=32, height=24, mode='path_tracer',"
        f" cache_dir={str(tmp_path)!r}), device='cpu')\n"
        "ldr = p.render_frame()\n"
        "p.shutdown()\n"
        "assert tuple(ldr.shape) == (24, 32, 3), ldr.shape\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad[:5]\n"
        "ref = sorted(m for m in sys.modules if m == 'hobbyrenderer_tpu'"
        " or m.startswith('hobbyrenderer_tpu.'))\n"
        "assert not ref, ref[:5]\n"
        "print('NOJAX_OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "NOJAX_OK" in res.stdout
