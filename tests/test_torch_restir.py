"""ReSTIR DI + Denoise of the PyTorch port against the JAX package on the
CPU: the whole restir frame against the JAX Renderer (stress:2, 96x64, 3
frames); ``restir_di`` on the JAX frame's own G-buffer and reservoirs; its
winner visibility against the plain any-hit; the reference's straggler
capacity; and the reduced-rate visibility path. The building blocks are
held against the JAX package in tests/test_torch_restir_ops.py.

The JAX CPU frame runs the XLA path: candidates from the XLA loop (its
uniforms come from utils/rng.uniform_from_bits, the port's K2 follows the
TPU kernel's 24-bit ``_u01``) and winner visibility as one plain any-hit.
The port follows the TPU branch (two tile-modal K4 passes, K3 stragglers);
at 96x64 the reference's fixed straggler capacity (max(R//32, 1024) lanes)
binds, so the parity runs lift it and the step cap (``straggler_steps=None``):
traced exactly, the visibility must then be the plain any-hit's, bit for
bit. At the reference's capacities the port is held against the JAX
package's TPU branch, run on the CPU in interpret mode."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.config import Config as JaxConfig
from hobbyrenderer_tpu.graph.rendergraph import FrameContext
from hobbyrenderer_tpu.ops import bvh as jbvh
from hobbyrenderer_tpu.renderer import Renderer as JaxRenderer
from hobbyrenderer_tpu_torch.config import Config
from hobbyrenderer_tpu_torch.ops import denoise as tdn
from hobbyrenderer_tpu_torch.ops import raster as traster
from hobbyrenderer_tpu_torch.ops import restir as trestir
from hobbyrenderer_tpu_torch.renderer import Renderer as TorchRenderer
from tests.torch_parity import same_mesh_cooker

W, H = 96, 64
FRAMES = 3
LIFT = dict(straggler_steps=None)
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
    """The JAX Renderer and the port (caps lifted) on stress:2 96x64
    restir, 3 frames: LDR, and per JAX frame the G-buffer, the denoised
    direct light, and the persistent state before and after."""
    if "frames" in _CACHE:
        return _CACHE["frames"]
    cache = os.path.join(str(tmp_root), "stress2")
    jr = JaxRenderer(JaxConfig(scene="stress:2", width=W, height=H, direct_mode="restir",
                               cache_dir=cache))
    m = jr._model

    def fn(gpu, rt, vc, settings, state, dt):
        ctx = FrameContext(gpu=gpu, vc=vc, settings=settings, config=m.config, dt=dt, rt=rt)
        out = m.graph.execute(ctx, state, outputs=("ldr", "raster_overflow", "gbuffer",
                                                   "restir_direct"))
        o = out["outputs"]
        return o["ldr"], {k: o[k] for k in ("raster_overflow", "gbuffer", "restir_direct")}, \
            out["state"]

    m._jitted = jax.jit(fn, donate_argnums=(4,))
    tr = TorchRenderer(Config(scene="stress:2", width=W, height=H, direct_mode="restir",
                              cache_dir=cache), device="cpu")
    vcs = []
    view_constants = tr.view_constants
    tr.view_constants = lambda: vcs.append(view_constants()) or vcs[-1]
    frames = []
    restir_di = trestir.restir_di
    trestir.restir_di = functools.partial(restir_di, **LIFT)   # the RTXDI pass's call
    try:
        for _ in range(FRAMES):
            before = _np({k: m.state[k] for k in ("restir_reservoir", "denoise_state")})
            lj = np.asarray(jr.render_frame())
            lt = tr.render_frame().numpy()
            after = _np({k: m.state[k] for k in ("restir_reservoir", "denoise_state")})
            frames.append(dict(ldr=(lj, lt), before=before, after=after, vc=vcs[-1],
                               gb=_np(m.last_stats["gbuffer"]),
                               direct=np.asarray(m.last_stats["restir_direct"])))
    finally:
        trestir.restir_di = restir_di
    jr.shutdown()
    tr.shutdown()
    _CACHE["frames"] = (frames, tr, np.asarray(m.rt.bvh.table), m.rt)
    return _CACHE["frames"]


@pytest.fixture(scope="module")
def tmp_root(tmp_path_factory):
    return tmp_path_factory.mktemp("torch_restir")


def _gbuffer(g):
    return traster.GBuffer(*[torch.as_tensor(np.array(getattr(g, f)))
                             for f in traster.GBuffer._fields])


def _reservoir(r):
    return trestir.Reservoir(y=torch.as_tensor(np.asarray(r.y).astype(np.int64)),
                             uv=torch.as_tensor(r.uv), w_sum=torch.as_tensor(r.w_sum),
                             M=torch.as_tensor(r.M), W=torch.as_tensor(r.W))


def _port_restir(tmp_root, k, **kw):
    """Port restir_di on JAX frame k's G-buffer with the JAX reservoir of
    frame k-1, with the balanced preset the frame runs."""
    frames, tr, _, _ = _frames(tmp_root)
    f = frames[k]
    so = {}
    out, res = trestir.restir_di(
        tr.gpu, tr._model.rt, _gbuffer(f["gb"]), f["vc"], tr.config.settings,
        _reservoir(f["before"]["restir_reservoir"]), k, num_candidates=8, spatial_taps=2,
        boiling_mult=20.0, vis_scale=2, stats_out=so, **kw)
    return out, res, so


@pytest.mark.parametrize("frame", [0, 1, 2], ids=["frame1", "frame2", "frame3"])
def test_restir_frame_matches_jax(tmp_root, frame):
    lj, lt = _frames(tmp_root)[0][frame]["ldr"]
    assert lt.shape == lj.shape and lt.dtype == np.uint8
    diff = np.abs(lj.astype(np.int32) - lt.astype(np.int32))
    assert np.mean(diff.max(-1) <= 2) >= 0.97, np.mean(diff.max(-1) <= 2)
    assert diff.mean() <= 1.5, diff.mean()


@pytest.mark.parametrize("frame", [1, 2], ids=["frame2", "frame3"])
def test_restir_di_matches_jax(tmp_root, frame):
    """Same G-buffer, same previous reservoir: winners agree on > 98% of
    pixels; the denoised direct light within 2% relative L1 (the
    reference's kernel-vs-XLA contract, tests/test_restir_kernel.py)."""
    f = _frames(tmp_root)[0][frame]
    out, res, so = _port_restir(tmp_root, frame, **LIFT)
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
    assert int(so["k3_lanes"]) > 0, "no straggler reached the bvh16 walk"


def test_winner_visibility_matches_plain_any_hit(tmp_root):
    """Two tile-modal K4 passes + every straggler through K3 == the JAX
    package's plain any-hit on the same rays, lane for lane."""
    _, _, bvh_table, jrt = _frames(tmp_root)
    seen = {}
    orig = trestir._winner_occlusion

    def spy(rt, o, L, tmax, shoot, y, h, w, so, steps):
        occ = orig(rt, o, L, tmax, shoot, y, h, w, so, steps)
        seen.update(o=o, L=L, tmax=tmax, shoot=shoot, occ=occ)
        return occ

    trestir._winner_occlusion = spy
    try:
        _port_restir(tmp_root, 2, **LIFT)
    finally:
        trestir._winner_occlusion = orig
    want = np.asarray(jbvh.bvh_any_hit(jrt.bvh, jnp.asarray(seen["o"].numpy()),
                                       jnp.asarray(seen["L"].numpy()),
                                       t_max=jnp.asarray(seen["tmax"].numpy())))
    shoot = seen["shoot"].numpy()
    assert 0.05 < want[shoot].mean() < 0.95, "degenerate case"
    np.testing.assert_array_equal(seen["occ"].numpy(), want)


def _capped_run(tmp_root):
    """Port restir_di on JAX frame 3 at the reference's capacities (the
    default), with the inputs and the result of its winner-visibility call."""
    if "capped" not in _CACHE:
        seen = {}
        orig = trestir._winner_occlusion

        def spy(rt, o, L, tmax, shoot, y, h, w, so, steps):
            occ = orig(rt, o, L, tmax, shoot, y, h, w, so, steps)
            seen.update(o=o, L=L, tmax=tmax, shoot=shoot, y=y, occ=occ)
            return occ

        trestir._winner_occlusion = spy
        try:
            out, _, so = _port_restir(tmp_root, 2)
        finally:
            trestir._winner_occlusion = orig
        _CACHE["capped"] = (out, so, seen)
    return _CACHE["capped"]


def test_capped_visibility_matches_jax_tpu_branch(tmp_root):
    """At the reference's capacities the port's winner visibility (two K4
    passes, K3 stragglers past max(R//32, 1024) counted occluded) equals the
    JAX package's TPU branch (force_kernel: the beam kernel in interpret
    mode, the bvh16 walk at 64 steps) lane for lane, and the stragglers past
    the capacity agree in number. The JAX overflow also counts beam tiles
    whose BFS frontier overflowed; the port's K4 walks each ray with a stack
    and has no frontier, so those tiles are counted apart."""
    from hobbyrenderer_tpu.ops import beam as jbeam
    from hobbyrenderer_tpu.ops import restir as jrestir
    _, so, seen = _capped_run(tmp_root)
    jrt = _frames(tmp_root)[3]

    def occlusion(o, L, tmax, shoot, y):
        so_j, beam_ovf = {}, []
        beam = jbeam.beam_any_hit

        def beam_spy(*a, **kw):
            occ, n = beam(*a, **kw)
            beam_ovf.append(n)
            return occ, n

        jbeam.beam_any_hit = beam_spy
        try:
            occ = jrestir._winner_occlusion(jrt, o, L, tmax, shoot, y, H, W, True, so_j)
        finally:
            jbeam.beam_any_hit = beam
        return occ, so_j["overflow"], sum(beam_ovf)

    want, ovf_j, beam_ovf_j = jax.jit(occlusion)(
        *[jnp.asarray(seen[k].numpy()) for k in ("o", "L", "tmax", "shoot")],
        jnp.asarray(seen["y"].numpy().astype(np.int32)))
    stragglers_j = int(ovf_j) - int(beam_ovf_j)
    assert stragglers_j > 0, "the capacity did not bind"
    np.testing.assert_array_equal(seen["occ"].numpy(), np.asarray(want))
    assert int(so["overflow"]) == stragglers_j


def test_capped_visibility_counts_overflow(tmp_root):
    """At the reference's capacities (the default) the stragglers past
    max(R//32, 1024) count as occluded and are reported as overflow."""
    out_l, _, _ = _port_restir(tmp_root, 2, **LIFT)
    out_c, so, _ = _capped_run(tmp_root)
    n = int(so["overflow"])
    assert n > 0 and int(so["k3_lanes"]) == 1024
    dark = (out_c.abs().sum(-1) == 0) & (out_l.abs().sum(-1) > 0)
    assert int(dark.sum()) > 0 and float(out_c.sum()) < float(out_l.sum())


def test_reduced_rate_visibility(tmp_root):
    """vis_scale=2 with the min-dim gate lowered: subgrid tracing + reuse +
    exact mismatch re-trace stays close to full rate (the reference's
    contract, tests/test_restir.py::test_reduced_rate_visibility_matches_full_rate)."""
    full, res_f, _ = _port_restir(tmp_root, 2, **LIFT)
    half, res_h, so = _port_restir(tmp_root, 2, vis_scale_min_dim=8, **LIFT)
    assert torch.equal(res_f.y, res_h.y)
    a, b = full.numpy(), half.numpy()
    assert not np.array_equal(a, b), "the reduced-rate path did not engage"
    assert np.abs(a - b).sum() / (np.abs(a).sum() + 1e-6) < 0.12
    assert (np.abs(a - b).max(-1) > 1e-4).mean() < 0.25
    assert int(so["overflow"]) == 0
