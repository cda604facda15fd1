"""The bvh16-walk step microbenchmarks K7-K9 (counterpart of
scripts/bench_wkernels.py's main()).

    python -m hobbyrenderer_tpu_torch.bench_wkernels [--device cpu]

Prints the script's lines: the five leaf-fetch variants of K7 (its "K1"),
K8 (its "K2") at Ip 4480 and 512 and K9 (its "K2b") at Ip 4480, each with
the time of one step in microseconds. The inputs are the script's, from
numpy's generator seeded with 3. On the GPU a call's time is CUDA events
around a run of launches, over their count, queued behind a spin kernel so
that the host's launch cost stays out of it; the per-step time is that
over the ITERS = 64 steps of a call. ``nq`` (the TPU's DMA semaphore
count) names the variant only: the H100 kernel has no counterpart of it.
``--device cpu`` times the plain versions with the host clock."""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from hobbyrenderer_tpu_torch.ops import wkernels as wk

N_LEAF = 65536
ITERS = 64
IP = 4480
K7_VARIANTS = (("rand rows=2048 nq=8", wk.RB, "rand"), ("rand rows=2048 nq=1", wk.RB, "rand"),
               ("rand rows=1024 nq=8", 1024, "rand"), ("rand rows=512  nq=8", 512, "rand"),
               ("seq  rows=2048 nq=8", wk.RB, "seq"))


def make_inputs(device, seed: int = 3):
    """The script's inputs, drawn in its order: leaf (65536, 128) f32, the
    random and sequential leaf ids (16, 128), the (96, 4480) bf16 interior
    table, its hc ordering, and ids below 4480 and below 512."""
    rng = np.random.default_rng(seed)
    leaf = rng.random((N_LEAF, wk.LANE), np.float32)
    idx_rand = rng.integers(0, N_LEAF, (wk.SUB, wk.LANE)).astype(np.int32)
    idx_seq = (np.arange(wk.RB) % N_LEAF).reshape(wk.SUB, wk.LANE).astype(np.int32)
    tab = rng.random((96, IP), np.float32)
    idx_ip = rng.integers(0, IP, (wk.SUB, wk.LANE)).astype(np.int32)
    idx_512 = rng.integers(0, 512, (wk.SUB, wk.LANE)).astype(np.int32)

    def t(a):
        return torch.as_tensor(a, device=device)

    tab_bf = t(tab).to(torch.bfloat16)
    return dict(leaf=t(leaf), idx_rand=t(idx_rand), idx_seq=t(idx_seq), tab=tab_bf,
                tab_hc=wk.hc_table(tab_bf), tab512=tab_bf[:, :512].contiguous(),
                idx_ip=t(idx_ip), idx_512=t(idx_512))


SPIN_CYCLES = 20_000_000     # ~10 ms of device clock: longer than queuing the calls


def call_ms(fn, device, n: int = 10, reps: int = 5) -> float:
    """Median over ``reps`` of the time of ``n`` back-to-back calls, over n
    (CUDA events on a GPU, the host clock on the CPU), after a warm-up. On
    the GPU the calls are queued while a spin kernel holds the stream, so
    the events time the device's work, not the host's launch rate."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            for _ in range(n):
                fn()
            b.record()
            torch.cuda.synchronize(device)
            times.append(a.elapsed_time(b) / n)
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / n)
    return float(np.median(times))


def main(argv=None):
    p = argparse.ArgumentParser(prog="hobbyrenderer_tpu_torch.bench_wkernels")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    a = p.parse_args(argv)
    from hobbyrenderer_tpu_torch.renderer import resolve_device
    dev = resolve_device(a.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "plain PyTorch"
    print(f"backend: {dev.type} ({name})", flush=True)
    x = make_inputs(dev)
    n = 10 if dev.type == "cuda" else 1
    for label, rows, kind in K7_VARIANTS:
        idx = x["idx_rand"] if kind == "rand" else x["idx_seq"]
        per = call_ms(lambda: wk.leaf_gather(idx, x["leaf"], rows, ITERS), dev, n) \
            / ITERS * 1e3
        print(f"K1 {label}: {per:8.2f} us/step  ({per / rows * 1e3:.1f} ns/row)", flush=True)
    dt = call_ms(lambda: wk.int_fetch(x["idx_ip"], x["tab"], ITERS, IP), dev, n)
    print(f"K2 onehot full Ip={IP}: {dt / ITERS * 1e3:8.2f} us/step", flush=True)
    dt = call_ms(lambda: wk.int_fetch_hc(x["idx_ip"], x["tab_hc"], ITERS, IP), dev, n)
    print(f"K2b factorized   Ip={IP}: {dt / ITERS * 1e3:8.2f} us/step", flush=True)
    dt = call_ms(lambda: wk.int_fetch(x["idx_512"], x["tab512"], ITERS, 512), dev, n)
    print(f"K2 onehot Ip=512 (shallow-only table): {dt / ITERS * 1e3:8.2f} us/step",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
