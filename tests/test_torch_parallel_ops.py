"""The port's row-band ops on 2 CPU ranks (gloo) against the port's
single-device ops, at the tolerance of the JAX test each one mirrors
(tests/test_parallel.py): the ReSTIR DI + denoise + TAA chain (rtol 1e-5,
atol 1e-6, the reservoir's light ids equal), bloom_sharded (rtol and atol
1e-5; at 1088 rows, where the bands stop a level before bloom(), against
the JAX package's bloom_sharded on a 2-device mesh), the
transparent pass over a banded G-buffer with the gathered
opaque frame (1e-5), the traced specular pass (1e-5), SSGI marching the
gathered depth and previous frame (1e-5), two frames of the combined SHARC
band (1e-5; the replicated caches' keys equal, radiance within 1e-6) and of
the DDGI band (1e-5; the replicated volumes within 1e-6), and the streaming
feedback summed over the ranks (equal). One spawn of the ranks runs them
all (tests/torch_parallel_ranks.py::ops_body)."""

import numpy as np
import pytest
import torch

from hobbyrenderer_tpu_torch.ops import post as postops
from hobbyrenderer_tpu_torch.ops import specular as specops
from hobbyrenderer_tpu_torch.ops import ssgi as ssgiops
from hobbyrenderer_tpu_torch.ops import transparent as transops
from hobbyrenderer_tpu_torch.parallel.launch import run_ranks
from tests import torch_parallel_ranks as tpr

N_RANKS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sharded():
    return run_ranks(tpr.ops_body, N_RANKS, deadline_s=240)[0]


def _close(got, ref, rtol, atol):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g, np.float64), r.numpy().astype(np.float64),
                                   rtol=rtol, atol=atol)


def test_restir_denoise_taa_chain(sharded):
    img, res, dn = tpr.restir_chain(*tpr.restir_inputs())
    ref = [img] + list(res) + list(dn)
    got = sharded["restir"]
    _close(got, ref, 1e-5, 1e-6)
    np.testing.assert_array_equal(got[1], res.y.numpy())      # the light ids


def test_bloom_sharded(sharded):
    hdr, settings = tpr.bloom_input()
    _close([sharded["bloom"]], [postops.bloom(hdr, settings)], 1e-5, 1e-5)


def test_bloom_sharded_matches_jax_at_1088_rows(sharded):
    """1088 rows on two ranks: the bands' level 5 is 17 rows, so the banded
    pyramid stops there, a level before bloom(); the JAX package's
    bloom_sharded on a 2-device mesh stops there too."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from hobbyrenderer_tpu.config import RenderSettings as JaxSettings
    from hobbyrenderer_tpu.ops import post as jpost
    from hobbyrenderer_tpu.ops import shard_utils as jshu
    from hobbyrenderer_tpu.parallel import build_mesh as jax_build_mesh
    shard_map = getattr(jax, "shard_map", None)
    if shard_map is None:       # older JAX
        from jax.experimental.shard_map import shard_map
    hdr, _ = tpr.bloom_input(*tpr.DEEP_BLOOM)
    H = hdr.shape[0]
    settings = JaxSettings().as_pytree()

    def body(x):
        sh = jshu.make_row_shard("tiles", N_RANKS, H // N_RANKS)
        return jpost.bloom_sharded(x, settings, sh, full_h=H)
    ref = jax.jit(shard_map(body, mesh=jax_build_mesh(N_RANKS), in_specs=(P("tiles"),),
                            out_specs=P("tiles"), check_vma=False))(jnp.asarray(hdr.numpy()))
    _close([sharded["bloom_deep"]], [torch.as_tensor(np.array(ref))], 1e-5, 1e-5)
    whole = postops.bloom(hdr, tpr.bloom_input()[1]).numpy()
    assert not np.allclose(sharded["bloom_deep"], whole, rtol=1e-5, atol=1e-5), \
        "the banded pyramid should stop a level before bloom()"


def test_transparent_banded(sharded):
    gpu, vc, settings, gb, hdr, kw = tpr.transparent_inputs()
    ref = transops.transparent_composite(gpu, vc, settings, gb, hdr, **kw)
    _close([sharded["transparent"]], [ref], 1e-5, 1e-5)


def test_specular_banded(sharded):
    gpu, rt, vc, settings, gb, st0, kw = tpr.specular_inputs()
    spec, w, st = specops.specular_indirect(gpu, rt, gb, vc, settings, st0, 2, **kw)
    _close(sharded["specular"], [spec, w] + list(st), 1e-5, 1e-5)


def test_ssgi_banded(sharded):
    gpu, vc, settings, gb, prev, irr = tpr.ssgi_inputs()
    _close([sharded["ssgi"]], [ssgiops.ssgi_half_res(gb, vc, prev, 5)], 1e-5, 1e-5)


def test_sharc_banded(sharded):
    gpu, rt, vc, settings, gb, irr = tpr.indirect_inputs()
    ind, cache = tpr.sharc_two_frames(gpu, rt, vc, settings, gb, irr)
    got = sharded["sharc"]
    _close(got[:1], [ind], 1e-5, 1e-5)
    np.testing.assert_array_equal(got[1], cache.key.numpy())
    assert (cache.key != 0).sum() > 0, "the cache was never populated"
    _close(got[2:], list(cache[1:]), 1e-6, 1e-6)


def test_ddgi_banded(sharded):
    gpu, rt, vc, settings, gb, irr = tpr.indirect_inputs()
    ind, vol = tpr.ddgi_two_frames(gpu, rt, vc, settings, gb)
    _close([sharded["ddgi"][0]], [ind], 1e-5, 1e-5)
    _close(sharded["ddgi"][1:], [f for f in vol if isinstance(f, torch.Tensor)], 1e-6, 1e-6)


def test_streaming_feedback_summed(sharded):
    W = H = 64
    gpu, _, cam, _ = tpr.setup("floor", W, H, streaming=True)
    ref = tpr.feedback(gpu, tpr.vc_of(cam), W, H).numpy()
    assert ref.sum() > 0, "no texture demand resolved"
    np.testing.assert_array_equal(sharded["feedback"], ref)
