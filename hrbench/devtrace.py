"""The device trace of the traced frames: ``torch.profiler`` around them,
reduced to the device's operations and the program's device-side ranges.

- ``ops``: every operation that ran on the device (kernels, copies, sets)
  as (name, start_us, end_us); ``kernels`` are those that are not copies
  or sets.
- ``ranges``: the device-side spans of the program's ``record_function``
  ranges (the render graph's pass names, ``PT bounce b``, ``PT compact b``,
  ``Frame/RTRefit``, ...), as (name, start_us, end_us).
- ``busy_us``: the union of the operations' intervals.
- a kernel belongs to the range in which it starts (the innermost where
  ranges nest)."""

from __future__ import annotations

import bisect
from typing import List, NamedTuple, Tuple

COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")

Span = Tuple[str, float, float]


class DeviceTrace(NamedTuple):
    ops: List[Span]
    ranges: List[Span]
    frames: int
    window_s: float         # host clock over the traced frames

    @property
    def kernels(self) -> List[Span]:
        return [k for k in self.ops if not k[0].startswith(COPY_PREFIXES)]


def from_profiler(prof, range_names) -> Tuple[List[Span], List[Span]]:
    """(device ops, device ranges) of a finished ``torch.profiler.profile``;
    ``range_names(name) -> bool`` tells the program's ranges apart."""
    import torch
    ops, ranges = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        (ranges if range_names(e.name) else ops).append(span)
    ops.sort(key=lambda s: s[1])
    ranges.sort(key=lambda s: s[1])
    return ops, ranges


def union_us(spans: List[Span]) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in sorted(spans, key=lambda x: x[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def range_of(kernels: List[Span], ranges: List[Span]) -> List[str]:
    """Each kernel's range: the latest-starting range that contains the
    kernel's start ("" where none does)."""
    starts = [r[1] for r in ranges]
    out = []
    for _, ks, _ in kernels:
        i = bisect.bisect_right(starts, ks) - 1
        name = ""
        while i >= 0:
            if ranges[i][1] <= ks < ranges[i][2]:
                name = ranges[i][0]
                break
            i -= 1
        out.append(name)
    return out


def kernel_ms_in(tr: DeviceTrace, pred_range, pred_kernel=lambda name: True) -> float:
    """Kernel ms a frame of the kernels whose range satisfies
    ``pred_range`` and whose name satisfies ``pred_kernel``."""
    ks = tr.kernels
    names = range_of(ks, tr.ranges)
    us = sum(e - s for (n, s, e), r in zip(ks, names) if pred_range(r) and pred_kernel(n))
    return us / 1e3 / tr.frames


def idle_gaps(tr: DeviceTrace, top: int = 10):
    """The longest gaps between device operations inside the traced frames,
    each named by the range of the operation that ends it (what the host
    was launching while the device waited): [[name, seconds], ...]."""
    ops = tr.ops
    names = range_of(ops, tr.ranges)
    gaps = []
    end = None
    for (n, s, e), r in zip(ops, names):
        if end is not None and s > end:
            gaps.append([r or "host (no range)", (s - end) / 1e6])
        end = e if end is None else max(end, e)
    gaps.sort(key=lambda g: -g[1])
    return gaps[:top]


def top_ops(tr: DeviceTrace, top: int = 10):
    """The device operations that took most time, summed by range and name:
    [["range | name", seconds], ...]."""
    names = range_of(tr.ops, tr.ranges)
    acc = {}
    for (n, s, e), r in zip(tr.ops, names):
        key = f"{r or 'host'} | {n}"[:120]
        acc[key] = acc.get(key, 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]
