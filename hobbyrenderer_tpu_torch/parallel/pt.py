"""Sample-parallel multi-GPU path tracer (counterpart of
hobbyrenderer_tpu/parallel/pt.py).

The scene and its BVH are replicated; every rank traces the whole pixel
grid with its own RNG stream: rank k of n renders accumulation frame
c * n + k of call c, so one call is the mean of n consecutive single-device
frames. The per-call mean is the ranks' samples summed in rank order
(Mesh.sum_ordered) over n: the same bits as the single-device
trace_paths(spp=n), whose spp frames are the same streams summed in the
same order. Accumulation, exposure and tonemap run replicated."""

from __future__ import annotations

import numpy as np
import torch

from hobbyrenderer_tpu_torch.models.pathtracer import trace_paths
from hobbyrenderer_tpu_torch.ops import atmosphere as atm
from hobbyrenderer_tpu_torch.ops import post as postops
from hobbyrenderer_tpu_torch.parallel.mesh import build_mesh


class PathTracerShardedRenderer:
    """render(gpu, vc, settings, dt, view_proj) -> the whole LDR frame on
    every rank; ``view_proj`` (the host camera matrix) resets the
    accumulation when it changes."""

    def __init__(self, gpu, width: int, height: int, rt, mesh=None, n_devices: int = 0,
                 config=None, env_as_lights: bool = False, spp: int = 1):
        self.mesh = mesh if mesh is not None else build_mesh(n_devices)
        self.n = self.mesh.n
        self.width, self.height = width, height
        self.rt = rt
        self.env_as_lights = env_as_lights
        self.spp = max(int(spp), 1)
        s = getattr(config, "settings", None)
        self.max_bounces = int(getattr(s, "max_bounces", 8) or 8)
        self.rr_start = int(getattr(s, "rr_start_bounce", 2) or 2)
        dev = self.mesh.device
        self.accum = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
        self.num_accum = 0          # samples accumulated (n * spp a call)
        self.exposure = torch.ones((), dtype=torch.float32, device=dev)
        self._prev_view = None
        self.last_stats = {}
        atm.device_tables(dev)

    def render(self, gpu, vc, settings, dt: float = 1 / 60, view_proj=None):
        vm = np.asarray(view_proj if view_proj is not None
                        else vc["view_proj_no_jitter"].cpu().numpy())
        if self._prev_view is None or not np.array_equal(vm, self._prev_view):
            self.num_accum = 0
            self.accum.zero_()
            self._prev_view = vm
        n, spp = self.n, self.spp
        call = self.num_accum // (n * spp)
        sample, self.last_stats = trace_paths(
            gpu, self.rt, vc, settings, self.height, self.width, call * n + self.mesh.rank,
            self.max_bounces, self.rr_start, env_as_lights=self.env_as_lights, spp=spp,
            with_stats=True)
        sample = self.mesh.sum_ordered(sample) / n
        sample = sample.reshape(self.height, self.width, 3)
        w = np.float32(n * spp) / (np.float32(self.num_accum) + np.float32(n * spp))
        self.accum = self.accum * float(np.float32(1.0) - w) + sample * float(w)
        hist = postops.luminance_histogram(self.accum)
        self.exposure = postops.exposure_adapt(hist, self.exposure, dt, settings)
        self.num_accum += n * spp
        return postops.tonemap_to_output(self.accum, self.exposure)
