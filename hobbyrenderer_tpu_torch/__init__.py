"""hobbyrenderer_tpu_torch — the PyTorch + CUDA port of hobbyrenderer_tpu.

The JAX package (``hobbyrenderer_tpu``) stays the reference. This package runs
the deferred frame in every (mode, direct, indirect) pair, the reference path
tracer, environment maps, animated scenes (refitted on the device), TAA
upscaling, texture streaming and the debug views with PyTorch on an explicit
device; the TPU kernels are hand-written CUDA C++ for Hopper (``csrc/``),
each beside a plain PyTorch version that runs on CPU tensors. ``parallel/``
renders on several GPUs with ``torch.distributed``, one process a rank: the
row-band deferred and flagship frames and the sample-parallel path tracer
(``parallel/launch.py::run_ranks`` starts the ranks, or torchrun).

The port keeps its own copies of the host modules it needs and imports
nothing of the JAX package: ``config``, ``scene.{scene,cooker,procedural,
camera,camera_state,loader,cache,textures,bc6h}``, ``utils.{math,image}``
and ``native`` (numpy, byte-for-byte the JAX package's behaviour;
``Config.as_pytree`` returns a plain dict). ``utils/timing.py`` is the
port's own tracer: spans on the profiler's clock, host syncs counted per
span, the path tracer's per-frame counters.

Layout mirrors the JAX package: ``scene/gpu.py``, ``graph/rendergraph.py``,
``ops/*.py``, ``models/deferred.py``, ``parallel/*.py``, ``renderer.py``,
``__main__.py``.
"""

__version__ = "0.1.0"
