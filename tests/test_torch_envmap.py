"""Environment maps and the remaining frame options of the PyTorch port
against the JAX package on the CPU.

The env ops: the .hdr codec (the same bytes and arrays as the JAX
package's), sample_equirect at the poles and across the azimuth seam from
both sides (within 1e-6 relative) and at random directions (within 2e-5:
atan2 agrees bit for bit, but XLA:CPU's arccos is up to 2 ulp off where
torch's is within 1, so on ~18% of directions the row coordinate moves by
an ulp or two of He, and the value by that share of the two rows'
difference; measured 1.2e-5), env_to_directional_lights and
project_sh9 (1e-6: the same numpy code over sh_basis), env_brdf_lut and
ibl_ambient with an env map and an authored LUT (2e-5 relative, the
reflection fetch's arccos; the LUT fetch alone 1e-6). Then the
options on CPU frames of the port: execute_per_pass gives the same bits as
execute, export_graph lists the JAX graph's passes, reads and writes, a
tune_file knob applies on the next frame, a .hdr screenshot decodes to the
kept HDR frame. Inputs come from numpy seeds; HDRs are written to a
temporary directory."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.config import Config as JaxConfig
from hobbyrenderer_tpu.config import RenderSettings as JaxSettings
from hobbyrenderer_tpu.ops import envmap as jenv
from hobbyrenderer_tpu.ops import ibl as jibl
from hobbyrenderer_tpu.renderer import Renderer as JaxRenderer
from hobbyrenderer_tpu_torch.config import Config, RenderSettings
from hobbyrenderer_tpu_torch.ops import envmap as tenv
from hobbyrenderer_tpu_torch.ops import ibl as tibl
from hobbyrenderer_tpu_torch.renderer import Renderer
from hobbyrenderer_tpu_torch.scene.workload import sky_envmap
from tests.torch_parity import same_mesh_cooker

SAMPLE_RTOL = {"poles_seam": 1e-6, "random": 2e-5}
AMBIENT_RTOL = 2e-5       # the reflection fetch's arccos (see the module docstring)
OPS_RTOL = 1e-6


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


@pytest.fixture(scope="module")
def env():
    return sky_envmap(64, 128, seed=3)


def _unit(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("width", [6, 130])      # flat scanlines, RLE scanlines
def test_hdr_codec_matches_jax(width):
    rng = np.random.default_rng(width)
    img = (rng.random((5, width, 3)) * np.logspace(-6, 4, width)[None, :, None]).astype(np.float32)
    img[0, 0] = 0.0
    data = tenv.encode_hdr(img)
    assert data == jenv.encode_hdr(img)
    got, want = tenv.decode_hdr(data), jenv.decode_hdr(data)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def test_load_envmap_matches_jax(tmp_path, env):
    """Each package decodes (and halves to max_width) its own copy."""
    for name in ("t.hdr", "j.hdr"):
        (tmp_path / name).write_bytes(tenv.encode_hdr(env))
    got = tenv.load_envmap(str(tmp_path / "t.hdr"), max_width=64)
    want = jenv.load_envmap(str(tmp_path / "j.hdr"), max_width=64)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (32, 64, 3)
    assert os.path.exists(str(tmp_path / "t.hdr") + ".64.npy")
    np.testing.assert_array_equal(tenv.load_envmap(str(tmp_path / "t.hdr"), max_width=64), got)


def _seam_and_poles():
    eps = np.float32(1e-7)
    return np.asarray([[0, 1, 0], [0, -1, 0], [0, 0, -1], [0, 0, 1],
                       [eps, 0, 1], [-eps, 0, 1], [1e-3, 0, 1], [-1e-3, 0, 1],
                       [0, 1, 1e-6], [0, -1, -1e-6]], np.float32)


@pytest.mark.parametrize("dirs", ["poles_seam", "random"])
def test_sample_equirect_matches_jax(env, dirs):
    if dirs == "random":
        d = _unit(np.random.default_rng(5), 4096)
    else:
        d = _seam_and_poles()
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
    got = tenv.sample_equirect(torch.as_tensor(env), torch.as_tensor(d)).numpy()
    want = np.asarray(jenv.sample_equirect(jnp.asarray(env), jnp.asarray(d)))
    np.testing.assert_allclose(got, want, rtol=SAMPLE_RTOL[dirs], atol=0)


def test_sample_equirect_seam_is_continuous(env):
    """Either side of the seam (u -> 0 and u -> 1) reads the same two
    columns, wrapped."""
    a = tenv.sample_equirect(torch.as_tensor(env), torch.tensor([[1e-6, 0.0, 1.0]]))
    b = tenv.sample_equirect(torch.as_tensor(env), torch.tensor([[-1e-6, 0.0, 1.0]]))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4)


def test_env_lights_and_sh_match_jax(env):
    got_d, got_c = tenv.env_to_directional_lights(env, 64)
    want_d, want_c = jenv.env_to_directional_lights(env, 64)
    np.testing.assert_allclose(got_d, want_d, rtol=OPS_RTOL, atol=1e-7)
    np.testing.assert_allclose(got_c, want_c, rtol=OPS_RTOL)
    for convolved in (False, True):
        np.testing.assert_allclose(tenv.project_sh9(env, convolved),
                                   jenv.project_sh9(env, convolved), rtol=OPS_RTOL,
                                   atol=1e-7)


def test_ibl_ambient_env_and_lut_match_jax(env):
    """The split-sum ambient with an env map (its SH projection and its
    reflection fetch) and an authored 32x32 LUT, at random shading points."""
    rng = np.random.default_rng(11)
    n = 2048
    nrm, v = _unit(rng, n), _unit(rng, n)
    v = np.where(np.sum(nrm * v, -1, keepdims=True) < 0, -v, v)
    alb = rng.random((n, 3)).astype(np.float32)
    metal = rng.random(n).astype(np.float32)
    rough = rng.random(n).astype(np.float32)
    lut = rng.random((32, 32, 2)).astype(np.float32)
    sh = jenv.project_sh9(env)
    sun = np.asarray([0.35, -0.75, 0.45], np.float32)
    t = {k: torch.as_tensor(a) for k, a in dict(nrm=nrm, v=v, alb=alb, metal=metal,
                                                 rough=rough, lut=lut, sh=sh, env=env,
                                                 sun=sun).items()}
    got = tibl.ibl_ambient(t["sh"], t["nrm"], t["v"], t["alb"], t["metal"], t["rough"],
                           t["sun"], RenderSettings(), intensity=1.5,
                           env_fn=lambda d: tenv.sample_equirect(t["env"], d),
                           brdf_lut=t["lut"]).numpy()
    want = np.asarray(jibl.ibl_ambient(
        jnp.asarray(sh), jnp.asarray(nrm), jnp.asarray(v), jnp.asarray(alb),
        jnp.asarray(metal), jnp.asarray(rough), jnp.asarray(sun), JaxSettings(),
        intensity=1.5, env_fn=lambda d: jenv.sample_equirect(jnp.asarray(env), d),
        brdf_lut=jnp.asarray(lut)))
    np.testing.assert_allclose(got, want, rtol=AMBIENT_RTOL, atol=1e-6)
    ndv, r = rng.random((n, 1)).astype(np.float32), rng.random((n, 1)).astype(np.float32)
    ndv[:4], r[:4] = [[0.0], [1.0], [1.0], [0.0]], [[0.0], [1.0], [0.0], [1.0]]
    for g, w in zip(tibl.env_brdf_lut(t["lut"], torch.as_tensor(ndv), torch.as_tensor(r)),
                    jibl.env_brdf_lut(jnp.asarray(lut), jnp.asarray(ndv), jnp.asarray(r))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=OPS_RTOL, atol=1e-7)


def _cfg(tmp_path, **kw):
    return Config(**dict(dict(scene="stress:2", width=64, height=48,
                              cache_dir=str(tmp_path / "hc")), **kw))


def test_execute_per_pass_same_bits(tmp_path, env):
    """The per-pass run computes what execute computes: equal LDR over two
    frames of the env-lit restir frame, and a time for every enabled pass."""
    path = str(tmp_path / "sky.hdr")
    with open(path, "wb") as f:
        f.write(tenv.encode_hdr(env))
    kw = dict(envmap=path, direct_mode="restir")
    a, b = Renderer(_cfg(tmp_path, **kw), device="cpu"), \
        Renderer(_cfg(tmp_path, execute_per_pass=True, **kw), device="cpu")
    for _ in range(2):
        assert torch.equal(a.render_frame(), b.render_frame())
    enabled = [p.name for p in b.graph.passes if p.enabled]
    assert [t["pass"] for t in b.graph.last_pass_timings] == enabled
    assert "Per-pass time" in b.timings() and not a.graph.last_pass_timings
    for r in (a, b):
        r.shutdown()


# resources in which the graphs differ by design: the JAX rasters' side
# table (the port's K1 resolves attributes without it) and the port's
# counters (written for Renderer.stats(), read by no pass)
NOT_COMPARED = {"raster_aux", "gi_traced", "ddgi_traced", "spec_past_cap"}
# declared reads the JAX graph has and the port's does not: DeferredLighting
# reads sun_shadow only where no RTXDI replaces it, SSGI no sky irradiance,
# ResolveGBuffer no slots (they serve the JAX side table)
JAX_ONLY_READS = {("DeferredLighting", "sun_shadow"), ("SSGI", "sky_irradiance"),
                  ("ResolveGBuffer", "visible_slots")}


def test_export_graph_matches_jax(tmp_path):
    """The passes in order with their enable state, reads and writes equal
    the JAX graph's (up to the documented differences above); resources
    carry the last frame's shapes."""
    kw = dict(scene="stress:2", width=64, height=48, direct_mode="restir",
              indirect_mode="restir", cache_dir=str(tmp_path / "hc"))
    tr = Renderer(Config(**kw), device="cpu")
    tr.render_frame()
    got = tr.export_graph()
    jr = JaxRenderer(JaxConfig(**kw))
    want = jr.export_graph()["passes"]
    assert [(p["name"], p["enabled"], p["persistent"]) for p in got["passes"]] == \
        [(p["name"], p["enabled"], p["persistent"]) for p in want]

    def kept(names):
        return {n for n in names if n not in NOT_COMPARED and not n.startswith("rt_k3_")}
    for g, w in zip(got["passes"], want):
        assert kept(g["writes"]) == kept(w["writes"]), g["name"]
        assert kept(g["reads"]) | {r for p, r in JAX_ONLY_READS if p == g["name"]} \
            == kept(w["reads"]), g["name"]
    assert got["resources"]["ldr"] == "(48, 64, 3):uint8"
    assert json.loads(json.dumps(got)) == got
    tr.shutdown()
    jr.shutdown()


def test_tune_file_applies_next_frame(tmp_path):
    """A knob written between frames changes the next frame's settings; a
    static or unknown key is ignored."""
    tune = tmp_path / "tune.json"
    r = Renderer(_cfg(tmp_path, tune_file=str(tune)), device="cpu")
    r.render_frame()
    assert r.config.settings.exposure_compensation == RenderSettings().exposure_compensation
    tune.write_text(json.dumps({"exposure_compensation": 2.5, "max_bounces": 3,
                                "no_such_knob": 1}))
    before = r.render_frame().float().mean()
    assert r.config.settings.exposure_compensation == 2.5
    assert r.config.settings.max_bounces == RenderSettings().max_bounces
    tune.write_text(json.dumps({"exposure_compensation": 0.0}))
    os.utime(tune, (0, 0))                 # an older file is not read again
    r.render_frame()
    assert r.config.settings.exposure_compensation == 2.5
    assert before.item() > 0
    r.shutdown()


def test_hdr_screenshot_decodes_to_hdr_frame(tmp_path):
    r = Renderer(_cfg(tmp_path, keep_hdr=True), device="cpu")
    r.render_frame()
    path = str(tmp_path / "shot.hdr")
    r.save_screenshot(path)
    hdr = r._model.last_resources["hdr"].numpy()
    with open(path, "rb") as f:
        dec = tenv.decode_hdr(f.read())
    assert dec.shape == hdr.shape
    # RGBE keeps 8 mantissa bits of the brightest channel
    m = hdr.max(-1, keepdims=True)
    assert np.all(np.abs(dec - hdr) <= m / 128 + 1e-30)
    r.shutdown()
