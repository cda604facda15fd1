"""hobbyrenderer_tpu_torch.utils.rng against the JAX uint32 PCG hashes:
bit-exact on seeded random words and on the edge values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyrenderer_tpu.utils import rng as jrng
from hobbyrenderer_tpu_torch.utils import rng as trng

EDGES = np.asarray([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF,
                    0xDEADBEEF, 65535, 65536], np.uint32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test workers on one machine: one torch thread
    each keeps the plain versions' many small ops from oversubscribing the
    cores (each op's thread team otherwise waits on descheduled threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(seed, n):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([w, EDGES])


def _t(a):
    return torch.as_tensor(a.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pcg3d_bit_exact(seed):
    v = _words(seed, 3 * 4000)[:3 * 4000].reshape(-1, 3)
    v = np.concatenate([v, np.stack([EDGES, EDGES[::-1], np.roll(EDGES, 3)], -1)])
    want = np.asarray(jrng.pcg3d(jnp.asarray(v)))
    got = trng.pcg3d(_t(v)).numpy()
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < 2 ** 32
    np.testing.assert_array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_pcg_hash_bit_exact(seed):
    x = _words(seed, 5000)
    want = np.asarray(jrng.pcg_hash(jnp.asarray(x)))
    np.testing.assert_array_equal(trng.pcg_hash(_t(x)).numpy().astype(np.uint32), want)


def test_uniform_from_bits_bit_exact():
    x = _words(5, 20000)
    want = np.asarray(jrng.uniform_from_bits(jnp.asarray(x)))
    got = trng.uniform_from_bits(_t(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_frame_keys_match():
    """The (pixel, frame, dim) keys the SunShadow and texture passes hash."""
    pix = np.arange(48 * 64, dtype=np.uint32)
    for frame, dim in ((0, 77), (3, 77), (7, 311)):
        v = np.stack([pix, np.full_like(pix, frame), np.full_like(pix, dim)], -1)
        want = np.asarray(jrng.uniform_from_bits(jrng.pcg3d(jnp.asarray(v))))
        got = trng.uniform_from_bits(trng.pcg3d(_t(v))).numpy()
        np.testing.assert_array_equal(got, want)
