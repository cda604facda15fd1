"""Module-level parity of the port's plain PyTorch ops with the JAX ops they
replace, on seeded inputs: ray helpers, sampling, shading, IBL, sky, HZB,
compaction, post, warp and TAA."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.config import RenderSettings as JaxRenderSettings
from hobbyrenderer_tpu.ops import atmosphere as jatm
from hobbyrenderer_tpu.ops import culling as jcull
from hobbyrenderer_tpu.ops import hzb as jhzb
from hobbyrenderer_tpu.ops import ibl as jibl
from hobbyrenderer_tpu.ops import intersect as jint
from hobbyrenderer_tpu.ops import post as jpost
from hobbyrenderer_tpu.ops import sampling as jsmp
from hobbyrenderer_tpu.ops import shading as jshade
from hobbyrenderer_tpu.ops import sky as jsky
from hobbyrenderer_tpu.ops import taa as jtaa
from hobbyrenderer_tpu.ops import warp as jwarp
from hobbyrenderer_tpu_torch.graph.rendergraph import (AccessError, FrameContext,
                                                       RenderGraph, render_pass)
from hobbyrenderer_tpu_torch.ops import atmosphere as tatm
from hobbyrenderer_tpu_torch.ops import culling as tcull
from hobbyrenderer_tpu_torch.ops import hzb as thzb
from hobbyrenderer_tpu_torch.ops import ibl as tibl
from hobbyrenderer_tpu_torch.ops import intersect as tint
from hobbyrenderer_tpu_torch.ops import post as tpost
from hobbyrenderer_tpu_torch.ops import sampling as tsmp
from hobbyrenderer_tpu_torch.ops import shading as tshade
from hobbyrenderer_tpu_torch.ops import sky as tsky
from hobbyrenderer_tpu_torch.ops import taa as ttaa
from hobbyrenderer_tpu_torch.config import RenderSettings
from hobbyrenderer_tpu_torch.ops import warp as twarp

SETTINGS = RenderSettings()            # the port's, handed to the port
JSETTINGS = JaxRenderSettings().as_pytree()
SUN = np.asarray([0.35, -0.75, 0.45], np.float32)
SUN = SUN / np.linalg.norm(SUN)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test workers on one machine: one torch thread
    each keeps the plain versions' many small ops from oversubscribing the
    cores (each op's thread team otherwise waits on descheduled threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit(rng, shape):
    v = rng.normal(size=shape + (3,)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _close(got, want, atol, rtol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=rtol)


def test_ray_helpers_and_cone_sampling():
    rng = np.random.default_rng(0)
    p = (rng.random((500, 3), np.float32) - 0.5) * 40
    n, d = _unit(rng, (500,)), _unit(rng, (500,))
    d[:5, 0] = 0.0
    _close(tint.offset_ray_origin(torch.as_tensor(p), torch.as_tensor(n), torch.as_tensor(d)),
           jint.offset_ray_origin(jnp.asarray(p), jnp.asarray(n), jnp.asarray(d)), 1e-6)
    _close(tint.safe_inv_dir(torch.as_tensor(d)), jint.safe_inv_dir(jnp.asarray(d)), 0, 1e-6)
    u1, u2 = rng.random(500, np.float32), rng.random(500, np.float32)
    t, b = tsmp.orthonormal_basis(torch.as_tensor(n))
    jt, jb = jsmp.orthonormal_basis(jnp.asarray(n))
    _close(t, jt, 1e-6)
    _close(b, jb, 1e-6)
    cos_max = float(np.cos(np.float32(SETTINGS.sun_angular_radius)))
    _close(tsmp.sample_cone(torch.as_tensor(n), cos_max, torch.as_tensor(u1), torch.as_tensor(u2)),
           jsmp.sample_cone(jnp.asarray(n), jnp.cos(JSETTINGS.sun_angular_radius),
                            jnp.asarray(u1), jnp.asarray(u2)), 1e-6)


def test_brdf_and_ibl_ambient():
    rng = np.random.default_rng(1)
    n, v, l = _unit(rng, (64, 48)), _unit(rng, (64, 48)), _unit(rng, (64, 48))
    alb = rng.random((64, 48, 3), np.float32)
    metal, rough = rng.random((64, 48), np.float32), rng.random((64, 48), np.float32)
    T = lambda a: torch.as_tensor(a)
    _close(tshade.eval_brdf(T(n), T(v), T(l), T(alb), T(metal), T(rough)),
           jshade.eval_brdf(*(jnp.asarray(a) for a in (n, v, l, alb, metal, rough))), 1e-5, 1e-4)
    sh = tibl.build_sky_irradiance(T(SUN), SETTINGS)
    jsh = jax.jit(jibl.build_sky_irradiance)(jnp.asarray(SUN), JSETTINGS)
    _close(sh, jsh, 1e-5, 1e-4)
    got = tibl.ibl_ambient(sh, T(n), T(v), T(alb), T(metal), T(rough), T(SUN), SETTINGS)
    want = jax.jit(jibl.ibl_ambient)(jsh, *(jnp.asarray(a) for a in (n, v, alb, metal, rough)),
                                     jnp.asarray(SUN), JSETTINGS)
    _close(got, want, 1e-4, 1e-3)


def test_atmosphere_luts_and_sky():
    jl, tl = jatm.build_luts(), tatm.build_luts()
    np.testing.assert_array_equal(tl.transmittance, jl.transmittance)
    np.testing.assert_array_equal(tl.multiscatter, jl.multiscatter)
    rng = np.random.default_rng(2)
    d = _unit(rng, (48, 64))
    d[20, 30] = -SUN                                      # on the sun disk
    got = tsky.sky_radiance_fast(torch.as_tensor(d), torch.as_tensor(SUN), SETTINGS)
    want = jax.jit(jsky.sky_radiance_fast)(jnp.asarray(d), jnp.asarray(SUN),
                                           JSETTINGS)
    _close(got, want, 1e-4, 1e-3)
    assert float(got[20, 30].min()) > 1000.0              # the disk itself


def test_hzb_and_compaction():
    rng = np.random.default_rng(3)
    depth = np.where(rng.random((96, 128)) > 0.3, rng.random((96, 128)), 0).astype(np.float32)
    h0, w0, levels = jhzb.hzb_sizes(128, 96)
    assert thzb.hzb_sizes(128, 96) == (h0, w0, levels)
    got = thzb.build_hzb(torch.as_tensor(depth), levels, h0, w0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jhzb.build_hzb(jnp.asarray(depth),
                                                                         levels, h0, w0)))
    mask = rng.random(1000) > 0.6
    for cap in (100, 1000):
        s, c = tcull.compact_mask(torch.as_tensor(mask), cap)
        js, jc = jcull.compact_mask(jnp.asarray(mask), cap)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        assert int(c) == int(jc)


def test_post_chain():
    rng = np.random.default_rng(4)
    hdr = (rng.random((48, 64, 3), np.float32) ** 4 * 20).astype(np.float32)
    st, sj = SETTINGS, JSETTINGS
    hist = tpost.luminance_histogram(torch.as_tensor(hdr))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jpost.luminance_histogram(jnp.asarray(hdr))))
    e = tpost.exposure_adapt(hist, torch.tensor(1.0), 1 / 60, st)
    je = jpost.exposure_adapt(jnp.asarray(hist.numpy()), jnp.float32(1.0), jnp.float32(1 / 60), sj)
    np.testing.assert_allclose(float(e), float(je), rtol=1e-5)
    _close(tpost.bloom(torch.as_tensor(hdr), st), jax.jit(jpost.bloom)(jnp.asarray(hdr), sj),
           1e-4, 1e-4)
    np.testing.assert_array_equal(
        tpost.tonemap_to_output(torch.as_tensor(hdr), 0.7).numpy(),
        np.asarray(jpost.tonemap_to_output(jnp.asarray(hdr), 0.7)))


@pytest.mark.parametrize("shift", [(0.3, -0.2), (3.6, 1.4), (-12.5, 7.25)])
def test_warp_and_taa(shift):
    rng = np.random.default_rng(5)
    img = rng.random((48, 64, 3), np.float32)
    motion = (np.asarray(shift, np.float32)
              + rng.normal(0, 0.4, (48, 64, 2)).astype(np.float32))
    _close(twarp.warp_image(torch.as_tensor(img), torch.as_tensor(motion)),
           jax.jit(jwarp.warp_image)(jnp.asarray(img), jnp.asarray(motion)), 1e-5)
    hdr = rng.random((48, 64, 3), np.float32) * 3
    for valid in (False, True):
        got = ttaa.taa_resolve(torch.as_tensor(hdr), torch.as_tensor(img),
                               torch.as_tensor(motion), valid, SETTINGS)
        want = jax.jit(jtaa.taa_resolve)(jnp.asarray(hdr), jnp.asarray(img),
                                         jnp.asarray(motion), jnp.bool_(valid),
                                         JSETTINGS)
        _close(got, want, 1e-5)


def _graph():
    g = RenderGraph()

    @g.add
    @render_pass("A", reads=("state",), writes=("x", "state"), persistent=("state",))
    def _a(ctx, res):
        res["x"] = res["state"] + 1
        res["state"] = res["x"]              # one tensor under two names

    @g.add
    @render_pass("B", reads=("x",), writes=("x",))
    def _b(ctx, res):
        res["x"] = res["x"] * 10             # a new tensor: state is untouched

    return g


def test_graph_state_and_validation():
    g = _graph()
    ctx = FrameContext(gpu=None, vc={}, settings=None)
    state = {"state": torch.zeros(2)}
    out = g.execute(ctx, state, outputs=("x",))
    assert out["x"].tolist() == [10.0, 10.0] and state["state"].tolist() == [1.0, 1.0]
    g.execute(ctx, state, outputs=("x",))
    assert state["state"].tolist() == [2.0, 2.0]
    assert "[ ] A" in g.describe() and "persistent=['state']" in g.describe()
    with pytest.raises(AccessError):
        g.execute(ctx, state, outputs=("nope",))

    bad = RenderGraph()

    @bad.add
    @render_pass("C", reads=(), writes=("y",))
    def _c(ctx, res):
        res["y"] = res["x"]

    with pytest.raises(AccessError):
        bad.execute(ctx, {}, outputs=("y",))
    with pytest.raises(ValueError):
        bad.add(dataclasses.replace(bad.get("C")))
