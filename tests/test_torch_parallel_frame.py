"""The port's sharded frames on 2 CPU ranks (gloo) against the port's
single-device frames (tests/test_parallel.py:21-54 and :759-795):

- DeferredShardedRenderer's cube frame within 1 LSB of the single-device
  DeferredRenderer's, the sky marched at full resolution on both sides
  (SKY_FAST_SCALE = 1: a band's strided sky is not the frame's);
- PathTracerShardedRenderer's accumulation, after each of two calls, equal
  bit for bit to the single-device path tracer's at 2 samples a frame
  (rank k traces accumulation frame 2c + k; their mean in rank order is
  trace_paths(spp=2)'s);
- the launcher's contract: a rank that raises fails the run with its
  traceback, and NCCL refuses more ranks than GPUs, naming gloo."""

import numpy as np
import pytest
import torch

from hobbyrenderer_tpu_torch.config import Config
from hobbyrenderer_tpu_torch.models.deferred import DeferredRenderer
from hobbyrenderer_tpu_torch.models.pathtracer import PathTracerRenderer
from hobbyrenderer_tpu_torch.ops import sky as skyops
from hobbyrenderer_tpu_torch.parallel.launch import RankError, run_ranks
from hobbyrenderer_tpu_torch.parallel.mesh import check_backend
from tests import torch_parallel_ranks as tpr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_deferred_sharded_matches_single_device():
    W, H = 96, 64
    got = run_ranks(tpr.deferred_body, 2, args=(W, H), deadline_s=120)
    old = skyops.SKY_FAST_SCALE
    skyops.SKY_FAST_SCALE = 1
    try:
        gpu, _, cam, settings = tpr.setup("cube", W, H)
        ref = DeferredRenderer(gpu, W, H, rt=None, shadow_scale=2).render(
            gpu, tpr.vc_of(cam), settings).numpy().astype(np.int32)
    finally:
        skyops.SKY_FAST_SCALE = old
    assert np.array_equal(got[0], got[1]), "the ranks' frames differ"
    assert got[0].shape == (H, W, 3) and got[0].dtype == np.uint8
    assert np.abs(got[0].astype(np.int32) - ref).max() <= 1


def test_pathtracer_sharded_equals_spp2():
    W, H, calls = 64, 32, 2
    got = run_ranks(tpr.pt_body, 2, args=(W, H, calls), deadline_s=120)
    gpu, rt, cam, settings = tpr.setup("cube", W, H, rt=True)
    single = PathTracerRenderer(gpu, W, H, config=Config(pt_spp=2), rt=rt)
    vc, vp = tpr.vc_of(cam), cam.view_constants(0)["view_proj_no_jitter"]
    for c in range(calls):
        single.render(gpu, vc, settings, 1 / 60, vp)
        assert np.array_equal(got[0][c], got[1][c]), f"call {c}: the ranks differ"
        assert np.array_equal(got[0][c], single.accum.numpy()), f"call {c}"


def test_rank_failure_raises_and_nccl_names_gloo():
    with pytest.raises(RankError, match="ValueError: boom"):
        run_ranks(tpr.failing_body, 2, timeout_s=30, deadline_s=60)
    with pytest.raises(ValueError, match="gloo"):
        check_backend("nccl", 2, ["cpu", "cpu"])
    with pytest.raises(ValueError, match="gloo"):
        run_ranks(tpr.failing_body, torch.cuda.device_count() + 1, backend="nccl",
                  devices=["cuda:0"] * (torch.cuda.device_count() + 1))
