"""The ranks of a multi-GPU frame and the few collectives it needs
(counterpart of hobbyrenderer_tpu/parallel/mesh.py).

The JAX package shards a frame over the "tiles" axis of a device mesh in
one process. Here each rank is a process of a ``torch.distributed`` group:
the mesh axis becomes the group, ``axis_index`` the rank (a host int), and
the ppermute halos, psums and all_gathers explicit collectives:

- ``all_gather``: every rank's tensor, in rank order (the primitive of the
  halo exchange, ops/shard_utils.extend_rows);
- ``all_gather_rows``: row bands -> the full frame;
- ``psum_int``: an all_reduce sum of counts (the luminance histogram's
  float32 counts, exact below 2**24; the streaming feedback's ints);
- ``sum_ordered``: float partials gathered and summed in rank order, so every
  rank gets the same bits, run to run and on either backend (a float
  all_reduce sums in whatever order the backend picks).

The group comes from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``) or from ``parallel/launch.py::run_ranks``. The backend is
the caller's: NCCL takes one GPU a rank, so ranks that share a card use
gloo, which moves CUDA tensors through the host (each of its collectives is
then a host sync, counted in ``Mesh.stats``)."""

from __future__ import annotations

import os
import time
from datetime import timedelta

import torch
import torch.distributed as dist

TILE_AXIS = "tiles"
INIT_TIMEOUT_S = 120
# all_gather into one tensor (renamed all_gather_single in later releases)
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def check_backend(backend: str, n: int, devices):
    """Raise ValueError unless ``backend`` can run ``n`` ranks on
    ``devices`` (one torch.device a rank): NCCL needs a distinct GPU a rank."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend '{backend}' (nccl | gloo)")
    if backend == "nccl":
        if any(torch.device(d).type != "cuda" for d in devices):
            raise ValueError("backend 'nccl' needs a CUDA device on every rank; CPU ranks "
                             "use backend='gloo'")
        if n > torch.cuda.device_count() or len({str(torch.device(d)) for d in devices}) < n:
            raise ValueError(f"backend 'nccl' needs one GPU a rank: {n} ranks, "
                             f"{torch.cuda.device_count()} visible GPUs; ranks that share a "
                             f"card need backend='gloo'")


class CollectiveStats:
    """What a rank's collectives moved: calls, bytes that landed on this
    rank, host syncs (gloo collectives of CUDA tensors), and with
    ``Mesh.timed`` the ms they took (device synchronised before and after
    each one, so that the time is the collective's alone)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.calls = 0
        self.bytes = 0
        self.host_syncs = 0
        self.ms = 0.0

    def as_dict(self):
        return dict(calls=self.calls, bytes=self.bytes, host_syncs=self.host_syncs,
                    ms=self.ms)


class Mesh:
    """This rank's view of the group: ``rank``, ``n``, ``device``, ``group``
    (None: the default group), ``backend`` and the collectives."""

    def __init__(self, rank: int, n: int, device, backend: str, group=None):
        self.rank, self.n = rank, n
        self.device = torch.device(device)
        self.backend = backend
        self.group = group
        self.stats = CollectiveStats()
        self.timed = False
        # gloo stages a CUDA tensor through host memory and blocks until done
        self._syncs_each = int(backend == "gloo" and self.device.type == "cuda")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, op, nbytes: int):
        if self.timed:
            self._sync()
            t0 = time.perf_counter()
        op()
        if self.timed:
            self._sync()
            self.stats.ms += (time.perf_counter() - t0) * 1e3
        self.stats.calls += 1
        self.stats.bytes += nbytes
        self.stats.host_syncs += self._syncs_each

    def all_gather(self, x):
        """Every rank's ``x`` (the same shape on each), stacked in rank order:
        (n, *x.shape)."""
        flat = x.reshape(-1).contiguous()
        out = torch.empty((self.n * flat.shape[0],), dtype=x.dtype, device=x.device)
        self._run(lambda: _all_gather_flat(out, flat, group=self.group),
                  out.numel() * out.element_size())
        return out.reshape((self.n,) + tuple(x.shape))

    def all_gather_rows(self, x):
        """Row bands (h, ...) -> the full frame (n * h, ...)."""
        return self.all_gather(x).reshape((self.n * x.shape[0],) + tuple(x.shape[1:]))

    def psum_int(self, x):
        """Sum of every rank's counts (exact: integers, or float32 counts
        below 2**24)."""
        y = x.clone()
        self._run(lambda: dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.group),
                  y.numel() * y.element_size())
        return y

    def sum_ordered(self, x):
        """Sum of every rank's float ``x`` in rank order: the same bits on
        every rank and backend."""
        parts = self.all_gather(x)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc


def _default_device(backend: str, local_rank: int):
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible: pass device='cpu' (with backend='gloo') "
                           "to run the ranks on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def build_mesh(n_devices: int = 0, *, backend: str = "nccl", device=None,
               timeout_s: float = INIT_TIMEOUT_S) -> Mesh:
    """This rank's Mesh. Joins the default process group, first creating it
    from torchrun's environment when this process has none (the launcher
    ``run_ranks`` creates it itself). ``n_devices`` (0: all) must equal the
    world size. ``device``: this rank's torch device; default
    ``cuda:LOCAL_RANK`` (modulo the visible GPUs)."""
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError("no process group: run the ranks under torchrun or "
                               "hobbyrenderer_tpu_torch.parallel.launch.run_ranks")
        world = int(os.environ["WORLD_SIZE"])
        dev = torch.device(device) if device is not None else _default_device(backend, local_rank)
        # torchrun places rank r on LOCAL_RANK's card: one a rank when they suffice
        check_backend(backend, world, [dev] if dev.type == "cpu" else
                      [torch.device("cuda", i % torch.cuda.device_count())
                       for i in range(world)])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, timeout=timedelta(seconds=timeout_s))
    world, rank = dist.get_world_size(), dist.get_rank()
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs '{dist.get_backend()}', not '{backend}'")
    if n_devices and n_devices != world:
        raise ValueError(f"n_devices={n_devices} but the group has {world} ranks")
    dev = torch.device(device) if device is not None else _default_device(backend, local_rank)
    return Mesh(rank, world, dev, backend)
