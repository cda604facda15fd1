"""Run a function on n ranks of a fresh process group, one process a rank.

The JAX package sees n devices in one process (``build_mesh(n)``); here
each rank is a process, so something must start them. ``run_ranks`` does
what ``torchrun`` does for one call:

    from hobbyrenderer_tpu_torch.parallel.launch import run_ranks
    results = run_ranks(body, 2, backend="gloo", devices=["cuda:0", "cuda:0"])

Each rank runs ``body(mesh, *args)`` with its ``parallel.mesh.Mesh`` and
returns a picklable value: numbers, numpy arrays, and tensors, which come
back as numpy arrays (a tensor would travel as a shared-memory handle that
dies with its rank). The ranks meet through a ``FileStore`` in a fresh temporary directory
(no port to clash with another run). ``body`` must be importable by name
from a module that the children can import (they start with ``spawn``).

A rank that raises fails the whole run: its traceback is re-raised here as
RankError and the other ranks are terminated. Every wait has a deadline:
``timeout_s`` bounds the group's set-up and each collective (a rank left
waiting in one raises), ``deadline_s`` the whole call."""

from __future__ import annotations

import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from hobbyrenderer_tpu_torch.parallel.mesh import INIT_TIMEOUT_S, build_mesh, check_backend


class RankError(RuntimeError):
    """A rank raised (its traceback is the message), or missed a deadline."""


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):        # a NamedTuple
        return type(x)(*[_to_host(v) for v in x])
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(fn, rank, n, backend, device, store_path, timeout_s, args, results):
    try:
        torch.set_num_threads(1)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, store=dist.FileStore(store_path, n), rank=rank,
                                world_size=n, timeout=timedelta(seconds=timeout_s))
        mesh = build_mesh(n, backend=backend, device=dev)
        results.put((rank, True, _to_host(fn(mesh, *args))))
    except BaseException:
        # posted before the group is torn down, so that this, the cause,
        # arrives before the errors of the ranks it leaves waiting
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, n: int, *, backend: str = "gloo", devices=None, args=(),
              timeout_s: float = INIT_TIMEOUT_S, deadline_s: float = 900.0):
    """[fn(mesh, *args) of rank 0, ..., of rank n-1]. ``devices``: one torch
    device a rank (default: "cpu" on every rank)."""
    devices = [torch.device(d) for d in (devices or ["cpu"] * n)]
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} ranks")
    check_backend(backend, n, devices)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="hr_ranks_")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, backend, str(devices[r]), os.path.join(tmp, "store"),
                               timeout_s, args, results), daemon=True)
             for r in range(n)]
    out = [None] * n
    started = []
    try:
        for p in procs:
            p.start()
            started.append(p)
        end = time.monotonic() + deadline_s
        got = 0
        while got < n:
            try:
                rank, ok, val = results.get(timeout=1.0)
            except queue_mod.Empty:
                # a rank killed by a signal posts nothing: fail at once
                dead = [r for r, p in enumerate(procs)
                        if out[r] is None and p.exitcode not in (None, 0)]
                if dead:
                    raise RankError(f"rank {dead[0]} of {n} exited with code "
                                    f"{procs[dead[0]].exitcode} and no result") from None
                if time.monotonic() > end:
                    raise RankError(f"no result from every rank within {deadline_s} s") from None
                continue
            if not ok:
                raise RankError(f"rank {rank} of {n} failed:\n{val}")
            out[rank] = val
            got += 1
        for p in started:
            p.join(timeout_s)
        return out
    finally:
        for p in started:
            if p.is_alive():
                p.terminate()
        for p in started:
            p.join(10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
