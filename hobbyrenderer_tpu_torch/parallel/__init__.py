"""Multi-GPU rendering on torch.distributed (counterpart of
hobbyrenderer_tpu/parallel/): the row-band deferred and flagship frames and
the sample-parallel path tracer, one process a rank (parallel/launch.py
starts them, or torchrun)."""

from hobbyrenderer_tpu_torch.parallel.mesh import build_mesh  # noqa: F401
from hobbyrenderer_tpu_torch.parallel.frame import DeferredShardedRenderer  # noqa: F401
from hobbyrenderer_tpu_torch.parallel.flagship import FlagshipShardedRenderer  # noqa: F401
from hobbyrenderer_tpu_torch.parallel.pt import PathTracerShardedRenderer  # noqa: F401
