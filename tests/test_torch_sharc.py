"""SHARC, the radiance cache, in the PyTorch port (ops/sharc.py) against the
JAX package (hobbyrenderer_tpu/ops/sharc.py) on the CPU, on a 2^12-entry
cache: several frames of update + resolve, the keys, the signed key
maximum of a slot, negative voxel coordinates, and the port's counterparts
of tests/test_sharc.py's round trip, eviction and base-collision probing.

Gates: keys and ages equal; radiance within 1e-5 relative (measured: the
port's per-slot sums add each slot's samples in a tree, the reference in
sorted order: max rel 2.2e-7 over the six frames below, 1.9e-7 with
negative coordinates)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.ops import sharc as jsharc
from hobbyrenderer_tpu_torch.ops import sharc as tsharc

N = 1 << 12
RAD_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test workers on one machine: one torch thread
    each keeps the plain versions' many small ops from oversubscribing the
    cores (each op's thread team otherwise waits on descheduled threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _samples(rng, R, lo=-6.0, hi=6.0):
    pos = rng.uniform(lo, hi, (R, 3)).astype(np.float32)
    nrm = rng.normal(size=(R, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    rad = rng.uniform(0, 2, (R, 3)).astype(np.float32)
    valid = rng.uniform(size=R) < 0.9
    return pos, nrm, rad, valid


def _assert_same(tc, jc):
    np.testing.assert_array_equal(tc.key.numpy(), np.asarray(jc.key).astype(np.int64))
    np.testing.assert_array_equal(tc.age.numpy(), np.asarray(jc.age))
    jr = np.asarray(jc.radiance)
    np.testing.assert_allclose(tc.radiance.numpy(), jr, rtol=RAD_RTOL, atol=1e-30)
    return float(np.max(np.abs(tc.radiance.numpy() - jr) / np.maximum(np.abs(jr), 1e-30)))


def _clustered(rng, centers, R):
    """Samples around fixed points with axis normals: cells recur from
    frame to frame (matches blend, new cells claim, others re-probe)."""
    pos = (centers[rng.integers(0, len(centers), R)]
           + rng.normal(scale=0.02, size=(R, 3))).astype(np.float32)
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    nrm = axes[rng.integers(0, 6, R)]
    rad = rng.uniform(0, 2, (R, 3)).astype(np.float32)
    return pos, nrm, rad, rng.uniform(size=R) < 0.9


def _run_both(frames, R=3000, seed=7, lo=-6.0, hi=6.0):
    """Frames of update + resolve in both packages on the same samples,
    with a camera that moves a little each frame."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(lo, hi, (600, 3))
    tc, jc = tsharc.sharc_init("cpu", N), jsharc.sharc_init(N)
    worst = 0.0
    for f in range(frames):
        pos, nrm, rad, valid = _clustered(rng, centers, R)
        cam = np.asarray([0.05 * f, 1.0, -0.03 * f], np.float32)
        tc = tsharc.sharc_resolve(tsharc.sharc_update(
            tc, torch.as_tensor(pos), torch.as_tensor(nrm), torch.as_tensor(rad),
            torch.as_tensor(valid), torch.as_tensor(cam)))
        jc = jsharc.sharc_resolve(jsharc.sharc_update(
            jc, jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(rad), jnp.asarray(valid),
            jnp.asarray(cam)))
        worst = max(worst, _assert_same(tc, jc))
    return tc, jc, worst, (pos, nrm, cam)


def test_cell_key_and_slots_match_jax():
    rng = np.random.default_rng(3)
    pos, nrm, _, _ = _samples(rng, 4096, -40.0, 40.0)
    cam = np.asarray([1.0, 2.0, 3.0], np.float32)
    kt = tsharc._cell_key(torch.as_tensor(pos), torch.as_tensor(nrm), torch.as_tensor(cam))
    kj = np.asarray(jsharc._cell_key(jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(cam)))
    np.testing.assert_array_equal(kt.numpy(), kj.astype(np.int64))
    assert (kt >= 1 << 31).any() and (kt < 1 << 31).any()
    np.testing.assert_array_equal(tsharc._probe_slots(kt, N).numpy(),
                                  np.asarray(jsharc._probe_slots(jnp.asarray(kj), N)))


def test_update_over_frames_matches_jax():
    """Six frames of 3,000 samples (90% valid) around 600 points into 4,096
    entries: cells recur and blend, slots are shared, keys collide and
    re-probe; every entry's key and age equal the reference's, its radiance
    within RAD_RTOL; the query agrees."""
    tc, jc, worst, (pos, nrm, cam) = _run_both(6)
    assert int((tc.key != 0).sum()) > 1000, "degenerate case"
    assert worst <= RAD_RTOL
    rt, ht = tsharc.sharc_query(tc, torch.as_tensor(pos), torch.as_tensor(nrm),
                                torch.as_tensor(cam))
    rj, hj = jsharc.sharc_query(jc, jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(cam))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    assert ht.numpy().mean() > 0.3
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=RAD_RTOL, atol=1e-30)


def test_negative_voxel_coordinates_match_jax():
    """Every coordinate negative: the voxel indices wrap mod 2^32 as the
    reference's astype(uint32) does."""
    tc, jc, worst, _ = _run_both(3, R=2000, seed=11, lo=-50.0, hi=-0.5)
    assert int((tc.key != 0).sum()) > 500
    assert worst <= RAD_RTOL


def test_signed_key_maximum_of_a_slot():
    """Two new keys whose probe windows share their base slot, one >= 2^31
    and one below: the slot takes the larger as a signed int32 (the one
    below 2^31), as the reference's segment_max over int32 keys does; an
    unsigned maximum would pick the other."""
    cam = np.zeros(3, np.float32)
    g = np.mgrid[0:24, 0:24].reshape(2, -1).T.astype(np.float32)
    pts = np.concatenate([g * 0.3 + 0.1, np.zeros((len(g), 1), np.float32)], 1)
    nrm = np.tile(np.asarray([[0, 1.0, 0]], np.float32), (len(pts), 1))
    keys = tsharc._cell_key(torch.as_tensor(pts), torch.as_tensor(nrm), torch.as_tensor(cam))
    base = tsharc._slot_of(keys, N).numpy()
    keys = keys.numpy()
    pair = None
    for i in range(len(pts)):
        for j in range(i + 1, len(pts)):
            if base[i] == base[j] and (keys[i] >= 1 << 31) != (keys[j] >= 1 << 31):
                pair = (i, j)
                break
        if pair:
            break
    assert pair is not None, "no straddling pair found among the candidates"
    pos, nn = pts[list(pair)], nrm[list(pair)]
    rad = np.asarray([[1.0, 0, 0], [0, 2.0, 0]], np.float32)
    tc = tsharc.sharc_update(tsharc.sharc_init("cpu", N), torch.as_tensor(pos),
                             torch.as_tensor(nn), torch.as_tensor(rad),
                             torch.ones(2, dtype=torch.bool), torch.as_tensor(cam))
    jc = jsharc.sharc_update(jsharc.sharc_init(N), jnp.asarray(pos), jnp.asarray(nn),
                             jnp.asarray(rad), jnp.ones(2, bool), jnp.asarray(cam))
    _assert_same(tc, jc)
    slot = int(base[pair[0]])
    assert int(tc.key[slot]) == int(min(keys[list(pair)])) < 1 << 31
    # the slot's radiance is the two samples' mean (both landed there)
    np.testing.assert_allclose(tc.radiance[slot].numpy(), rad.mean(0), rtol=1e-6)


def test_update_is_the_same_bits_run_to_run():
    rng = np.random.default_rng(5)
    pos, nrm, rad, valid = (torch.as_tensor(a) for a in _samples(rng, 5000))
    cam = torch.zeros(3)
    a = tsharc.sharc_update(tsharc.sharc_init("cpu", N), pos, nrm, rad, valid, cam)
    b = tsharc.sharc_update(tsharc.sharc_init("cpu", N), pos, nrm, rad, valid, cam)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_segment_scan_matches_sequential_sums():
    """The tree-ordered segmented scan against a per-run loop."""
    rng = np.random.default_rng(9)
    seg = np.sort(rng.integers(0, 40, 300))
    vals = rng.uniform(0, 1, (300, 2)).astype(np.float32)
    out = tsharc._per_slot(tsharc._segment_scan(torch.as_tensor(vals), torch.as_tensor(seg),
                                                torch.add), torch.as_tensor(seg), 40, 0.0)
    want = np.zeros((40, 2), np.float64)
    np.add.at(want, seg, vals.astype(np.float64))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6)


# ---- the port's counterparts of tests/test_sharc.py:9, 28, 56 ----

def test_sharc_insert_query_roundtrip(rng):
    cache = tsharc.sharc_init("cpu", N)
    cam = torch.zeros(3)
    pos = torch.as_tensor(rng.uniform(-5, 5, (256, 3)).astype(np.float32))
    nrm = torch.as_tensor(np.tile([[0, 1, 0]], (256, 1)).astype(np.float32))
    rad = torch.as_tensor(rng.uniform(0, 2, (256, 3)).astype(np.float32))
    cache = tsharc.sharc_update(cache, pos, nrm, rad, torch.ones(256, dtype=torch.bool), cam)
    out, hit = tsharc.sharc_query(cache, pos, nrm, cam)
    assert hit.float().mean() > 0.95, f"most samples should hit their own cell: {hit}"
    assert (out[hit].sum(-1) > 0).all()
    _, miss = tsharc.sharc_query(cache, pos + 1000.0, nrm, cam)
    assert not miss.any()


def test_sharc_eviction():
    cache = tsharc.sharc_init("cpu", 1 << 10)
    cam = torch.zeros(3)
    pos = torch.tensor([[1.0, 0, 0]])
    nrm = torch.tensor([[0, 1.0, 0]])
    cache = tsharc.sharc_update(cache, pos, nrm, torch.ones((1, 3)),
                                torch.ones(1, dtype=torch.bool), cam)
    assert tsharc.sharc_query(cache, pos, nrm, cam)[1][0]
    for _ in range(int(2 * tsharc.STALE_FRAMES) + 2):
        cache = tsharc.sharc_resolve(cache)
    assert not tsharc.sharc_query(cache, pos, nrm, cam)[1][0], \
        "stale entries must stop resolving"


def test_sharc_linear_probing_survives_base_collision():
    """Two cells whose keys hash to the same base slot both stay cached."""
    n = 1 << 10
    cam = torch.zeros(3)
    cand = np.mgrid[0:12, 0:12].reshape(2, -1).T.astype(np.float32)
    pts = torch.as_tensor(np.concatenate([cand * 0.3 + 0.1, np.zeros((len(cand), 1))], 1)
                          .astype(np.float32))
    nrm = torch.tensor([[0, 1.0, 0]])
    keys = tsharc._cell_key(pts, nrm.expand(len(pts), 3), cam)
    bases = tsharc._slot_of(keys, n).tolist()
    seen, pair = {}, None
    for i, b in enumerate(bases):
        if b in seen and int(keys[seen[b]]) != int(keys[i]):
            pair = (seen[b], i)
            break
        seen.setdefault(b, i)
    assert pair is not None, "no base-slot collision found in the candidates"
    pos = pts[list(pair)]
    nn = nrm.expand(2, 3)
    rad = torch.tensor([[1.0, 0, 0], [0, 2.0, 0]])
    cache = tsharc.sharc_init("cpu", n)
    for _ in range(2):
        cache = tsharc.sharc_update(cache, pos, nn, rad, torch.ones(2, dtype=torch.bool), cam)
    out, hit = tsharc.sharc_query(cache, pos, nn, cam)
    assert hit.all(), "probing must keep both colliding cells"
    assert out[0, 0] > 0.5 and out[1, 1] > 1.0, f"wrong values: {out}"
    assert out[1, 1] > out[1, 0] and out[0, 0] > out[0, 1]
