"""The sorted-block trace route of the PyTorch port (ops/trace.py,
ops/trace_kernel.py) against the JAX package on the CPU: the coherence key
and block packing bit for bit, K6's plain version against the Pallas kernel
``closest_hit_blocks`` in interpret mode on the same packed blocks, the
port's ``trace_closest`` and ``trace_any_hit`` against the JAX package's,
and, on a GPU, the CUDA kernel against its plain version.

The scene is tests/test_trace.py's triangle soup (700 triangles, 1,500
incoherent rays: 2 blocks). One ray set carries inactive lanes and per-ray
t_max (finite on some, none on others), so one interpret-mode call of each
Pallas function covers both cases; a second K6 call, with the frontier cut
to 64 nodes on both sides, covers the overflow path. Tolerances: hit triangles, fronts and
overflow flags identical; t within 1e-5 relative, u and v within 1e-5 of
their [0, 1] range (measured: t 1.2e-6 relative, u and v 2.4e-6 absolute, a
cancellation in the dot products): XLA:CPU contracts some products into
FMAs, the port rounds each one (ROADMAP Queue 3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.ops import beam as jbeam
from hobbyrenderer_tpu.ops import bvh as jbvh
from hobbyrenderer_tpu.ops import trace as jtrace
from hobbyrenderer_tpu_torch.ops import beam as tbeam
from hobbyrenderer_tpu_torch.ops import bvh as tbvh
from hobbyrenderer_tpu_torch.ops import trace as ttrace
from hobbyrenderer_tpu_torch.ops import trace_kernel as tk

R = 1500
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


def _tri_soup(n, seed=0, spread=4.0, size=0.5):
    rng = np.random.default_rng(seed)
    c = (rng.random((n, 1, 3), np.float32) - 0.5) * spread
    v = c + (rng.random((n, 3, 3), np.float32) - 0.5) * size
    return v.astype(np.float32)


def _rays(n, seed=1, spread=3.0):
    """GI-bounce-like rays: random origins inside the scene, random
    directions; every 10th lane inactive, every 3rd with a finite t_max."""
    rng = np.random.default_rng(seed)
    o = ((rng.random((n, 3), np.float32) - 0.5) * spread).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(np.arange(n) % 3 == 0, rng.uniform(0.3, 2.5, n), 1e30).astype(np.float32)
    active = np.arange(n) % 10 != 7
    return o, d, t_max, active


def _scene():
    if "scene" not in _CACHE:
        tris = _tri_soup(700)
        jb = jbvh.build_bvh(tris)
        tb = tbvh.build_bvh(tris)
        np.testing.assert_array_equal(tb.table, np.asarray(jb.table))
        btable = tbeam.beam_table(tb.table)
        o, d, t_max, active = _rays(R)
        _CACHE["scene"] = (jb, tb, btable, o, d, t_max, active)
    return _CACHE["scene"]


def _blocks():
    """Both packages' packed blocks, and the JAX kernel's raw block outputs
    (one interpret-mode call)."""
    if "blocks" not in _CACHE:
        jb, tb, btable, o, d, t_max, active = _scene()
        j_rays, j_order = jtrace.pack_rays_sorted(jnp.asarray(o), jnp.asarray(d),
                                                  jnp.asarray(t_max), jnp.asarray(active),
                                                  jb.root_box)
        j_out = jtrace.closest_hit_blocks(jnp.asarray(btable), j_rays, interpret=True)
        t_rays, t_order = ttrace.pack_rays_sorted(
            torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max),
            torch.as_tensor(active), torch.as_tensor(tb.root_box))
        _CACHE["blocks"] = (np.asarray(j_rays), np.asarray(j_order),
                            [np.asarray(x) for x in j_out], t_rays, t_order)
    return _CACHE["blocks"]


def test_coherence_key_matches_jax():
    jb, tb, _, o, d, _, _ = _scene()
    want = np.asarray(jtrace.coherence_key(jnp.asarray(o), jnp.asarray(d), jb.root_box))
    got = ttrace.coherence_key(torch.as_tensor(o), torch.as_tensor(d),
                               torch.as_tensor(tb.root_box)).numpy()
    assert len(np.unique(want)) > 100, "degenerate keys"
    np.testing.assert_array_equal(got, want)


def test_pack_matches_jax_and_roundtrips():
    """Same blocks and permutation as the JAX package; pack -> unpack is the
    identity on a ray payload."""
    j_rays, j_order, _, t_rays, t_order = _blocks()
    assert tuple(t_rays.shape) == (2, 8, tk.PIX)
    np.testing.assert_array_equal(t_order.numpy(), j_order)
    np.testing.assert_array_equal(t_rays.numpy(), j_rays)
    payload = torch.arange(R, dtype=torch.float32)
    padded = torch.nn.functional.pad(payload[t_order], (0, 2 * tk.PIX - R))
    back = ttrace.unpack_sorted(padded.reshape(-1, tk.PIX), t_order, R)
    assert torch.equal(back, payload)


def test_closest_hit_blocks_plain_matches_pallas():
    """K6's plain version on the JAX package's packed blocks against the
    Pallas kernel in interpret mode."""
    j_rays, _, j_out, _, _ = _blocks()
    stats = {}
    got = tk.closest_hit_blocks_reference(torch.as_tensor(_scene()[2]),
                                          torch.as_tensor(j_rays.copy()), stats=stats)
    t, tri, u, v, f = [x.reshape(2, tk.PIX) for x in j_out[:5]]
    np.testing.assert_array_equal(got[1].numpy(), tri)
    np.testing.assert_array_equal(got[4].numpy(), f)
    np.testing.assert_array_equal(got[5].numpy(), j_out[5])
    hit = tri >= 0
    assert 0.1 < hit.mean() < 0.9, "degenerate case"
    np.testing.assert_allclose(got[0].numpy(), t, rtol=1e-5)
    np.testing.assert_allclose(got[2].numpy()[hit], u[hit], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[3].numpy()[hit], v[hit], rtol=0, atol=1e-5)
    assert stats["rows"] > 2 and stats["leaf_rows"] > 0


def test_closest_hit_blocks_overflow_matches_pallas(monkeypatch):
    """The overflow path: with the frontier cut to 64 nodes on both sides
    (FCAP is a module constant of each), both blocks overflow. The plain
    version keeps the Pallas kernel's drop order (the 63 first children of a
    level in (row, child) order) and its flags; same tolerances."""
    import jax
    j_rays, _, _, _, _ = _blocks()
    btable = _scene()[2]
    monkeypatch.setattr(jtrace, "FCAP", 64)
    monkeypatch.setattr(tk, "FCAP", 64)
    # a new function to trace: the jit's cached trace holds FCAP 4096
    pallas = jax.jit(lambda b, r: jtrace.closest_hit_blocks.__wrapped__(b, r, interpret=True))
    t, tri, u, v, f, ovf = [np.asarray(x) for x in pallas(jnp.asarray(btable),
                                                           jnp.asarray(j_rays))]
    got = tk.closest_hit_blocks_reference(torch.as_tensor(btable), torch.as_tensor(j_rays.copy()))
    np.testing.assert_array_equal(ovf, [1.0, 1.0])
    np.testing.assert_array_equal(got[5].numpy(), ovf)
    np.testing.assert_array_equal(got[1].numpy(), tri)
    np.testing.assert_array_equal(got[4].numpy(), f)
    hit = tri >= 0
    assert 0.02 < hit.mean() < 0.15, "degenerate case"   # 0.19 with the full frontier
    np.testing.assert_allclose(got[0].numpy(), t, rtol=1e-5)
    np.testing.assert_allclose(got[2].numpy()[hit], u[hit], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[3].numpy()[hit], v[hit], rtol=0, atol=1e-5)


def test_trace_closest_matches_jax():
    """The port's trace_closest against the JAX package's HitRecord built
    from the same kernel outputs (JAX's unpack): inactive lanes miss,
    finite t_max clips."""
    jb, tb, btable, o, d, t_max, active = _scene()
    _, j_order, j_out, _, _ = _blocks()
    tri_o = np.asarray(jtrace.unpack_sorted(jnp.asarray(j_out[1]), jnp.asarray(j_order),
                                            R)).astype(np.int32)
    got = ttrace.trace_closest(torch.as_tensor(btable), tb.root_box, torch.as_tensor(o),
                               torch.as_tensor(d), t_max=torch.as_tensor(t_max),
                               active=torch.as_tensor(active))
    np.testing.assert_array_equal(got.tri.numpy(), tri_o)
    assert (got.tri.numpy()[~active] == -1).all()
    hit = tri_o >= 0
    assert (got.t.numpy()[hit] < t_max[hit]).all()
    assert (got.t.numpy()[~hit] >= 1e30).all()           # the miss sentinel (INF)
    t_o = np.asarray(jtrace.unpack_sorted(jnp.asarray(j_out[0]), jnp.asarray(j_order), R))
    np.testing.assert_allclose(got.t.numpy()[hit], t_o[hit], rtol=1e-5)
    # the capped lanes agree with the uncapped wavefront's hits below t_max
    ref = jbvh.bvh_closest_hit(jb, jnp.asarray(o), jnp.asarray(d))
    ref_hit = active & (np.asarray(ref.tri) >= 0) & (np.asarray(ref.t) < t_max)
    np.testing.assert_array_equal(hit, ref_hit)


def test_closest_hit_auto_force_kernel_routes():
    """force_kernel with a beam table takes the sorted-block route (K6's
    plain version here, K4's for any hit), else the bvh16 walk: the same
    triangles and occlusion."""
    from types import SimpleNamespace
    from hobbyrenderer_tpu_torch.ops import bvh16 as tb16
    jb, tb, btable, o, d, _, active = _scene()
    rt = SimpleNamespace(btable=torch.as_tensor(btable), bvh=tb,
                         bvh16=tb16.build_bvh16(_tri_soup(700), "cpu"))
    args = (rt, torch.as_tensor(o), torch.as_tensor(d))
    blk, capped = ttrace.closest_hit_auto(*args, active=torch.as_tensor(active),
                                          force_kernel=True, return_capped=True)
    walk = ttrace.closest_hit_auto(*args, active=torch.as_tensor(active))
    assert not capped.any()
    assert torch.equal(blk.tri, walk.tri)
    hit = walk.tri >= 0
    torch.testing.assert_close(blk.t[hit], walk.t[hit], rtol=1e-5, atol=0)
    tm = torch.full((R,), 1.5)
    occ_blk = ttrace.any_hit_auto(*args, t_max=tm, force_kernel=True)
    occ_walk = ttrace.any_hit_auto(*args, t_max=tm)
    assert occ_walk.any() and not occ_walk.all()
    assert torch.equal(occ_blk, occ_walk)


def test_trace_any_hit_matches_jax():
    """The coherence sort in front of K4: occlusion identical to the JAX
    package's trace_any_hit (the beam kernel in interpret mode), on all
    lanes active (the Pallas beam kernel does not mask inactive lanes)."""
    jb, tb, btable, o, d, t_max, _ = _scene()
    tm = np.minimum(t_max, 2.5)
    want = np.asarray(jtrace.trace_any_hit(jnp.asarray(btable), jb.root_box, jnp.asarray(o),
                                           jnp.asarray(d), t_max=jnp.asarray(tm),
                                           interpret=True))
    got = ttrace.trace_any_hit(torch.as_tensor(btable), tb.root_box, torch.as_tensor(o),
                               torch.as_tensor(d), t_max=torch.as_tensor(tm)).numpy()
    assert want.any() and not want.all(), "degenerate case"
    np.testing.assert_array_equal(got, want)
    assert jbeam.PIX == tk.PIX


@pytest.mark.cuda
def test_cuda_k6_matches_plain(cuda_device):
    """The CUDA kernel against its plain version, bit for bit, on 6 blocks
    of a 3,000-triangle soup (inactive lanes and finite t_max included),
    launched three times (equal bits each time)."""
    tris = _tri_soup(3000, seed=4)
    tb = tbvh.build_bvh(tris)
    btable = torch.as_tensor(tbeam.beam_table(tb.table)).to(cuda_device)
    o, d, t_max, active = _rays(6 * tk.PIX, seed=9)
    rays, _ = ttrace.pack_rays_sorted(torch.as_tensor(o), torch.as_tensor(d),
                                      torch.as_tensor(t_max), torch.as_tensor(active),
                                      torch.as_tensor(tb.root_box))
    rays = rays.to(cuda_device)
    n0 = tk.launches
    runs = [tk.closest_hit_blocks(btable, rays) for _ in range(3)]
    torch.cuda.synchronize()
    assert tk.launches == n0 + 3
    ref = tk.closest_hit_blocks_reference(btable, rays)
    for got in runs:
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    assert (runs[0][1] >= 0).any()


def test_flagship_frame_on_the_sorted_block_route(tmp_path):
    """The flagship frame's GI bounce and reflection rays, captured on the
    default route (the bvh16 walk), through closest_hit_auto(force_kernel=
    True): one K6 call (its plain version here) per ray set, and on every
    lane of a block whose frontier did not overflow the uncapped walk's
    triangle (or, on a tie, its t)."""
    from hobbyrenderer_tpu_torch.config import Config
    from hobbyrenderer_tpu_torch.renderer import Renderer
    r = Renderer(Config(scene="stress:2", width=96, height=64, direct_mode="restir",
                        indirect_mode="restir", cache_dir=str(tmp_path)), device="cpu")
    seen = []
    counted = ttrace.closest_hit_counted

    def spy(rt, o, d, active, max_steps=None):
        seen.append((rt, o, d, active))
        return counted(rt, o, d, active, max_steps=max_steps)
    ttrace.closest_hit_counted = spy
    try:
        ldr = r.render_frame()
    finally:
        ttrace.closest_hit_counted = counted
    r.shutdown()
    assert ldr.shape == (64, 96, 3) and int(ldr.max()) > 0
    assert len(seen) == 2                      # GI bounce, then the reflection rays
    k6 = tk.closest_hit_blocks
    for rt, o, d, active in seen:
        outs = []
        tk.closest_hit_blocks = lambda *a, **k: outs.append(k6(*a, **k)) or outs[-1]
        try:
            blk = ttrace.closest_hit_auto(rt, o, d, active=active, force_kernel=True)
        finally:
            tk.closest_hit_blocks = k6
        assert len(outs) == 1
        walk = ttrace.closest_hit_auto(rt, o, d, active=active)
        R = o.shape[0]
        _, order = ttrace.pack_rays_sorted(o, d, torch.full((R,), ttrace.TMAX_CAP), active,
                                           torch.as_tensor(rt.bvh.root_box))
        ovf = outs[0][5]
        ovf_lane = ttrace.unpack_sorted(ovf[:, None].expand(-1, tk.PIX), order, R) > 0.5
        clean = active & ~ovf_lane
        assert int(clean.sum()) > 0 and bool((walk.tri[clean] >= 0).any())
        same = (blk.tri == walk.tri) | (blk.t == walk.t)
        assert bool(same[clean].all()), int((~same & clean).sum())
        assert bool((blk.tri[~active] == -1).all())
