"""Per-pass timing + frame stats (observability layer).

Reference: microprofile CPU/GPU scopes + per-pass double-buffered TimerQueryHandles
(src/RenderGraph.cpp:329-349) displayed in the ImGui timing table. TPU equivalent:
host wall-clock scopes around block_until_ready'd pass boundaries (only meaningful in
--execute-per-pass mode — inside one jitted frame XLA owns the schedule), plus
jax.profiler trace hooks for real kernel-level analysis."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List


class FrameProfiler:
    """Accumulates named CPU scopes; like the reference's SimpleTimer + timing table."""

    def __init__(self):
        self.scopes: Dict[str, float] = defaultdict(float)
        self.history: List[Dict[str, float]] = []

    @contextlib.contextmanager
    def scope(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.scopes[name] += (time.perf_counter() - t0) * 1000.0

    def end_frame(self):
        self.history.append(dict(self.scopes))
        self.scopes = defaultdict(float)

    def summary(self, last_n: int = 16) -> Dict[str, float]:
        if not self.history:
            return {}
        hist = self.history[-last_n:]
        keys = set().union(*hist)
        return {k: sum(h.get(k, 0.0) for h in hist) / len(hist) for k in sorted(keys)}

    def table(self, last_n: int = 16) -> str:
        s = self.summary(last_n)
        if not s:
            return "(no timing data)"
        width = max(len(k) for k in s)
        lines = [f"{k:<{width}}  {v:8.3f} ms" for k, v in sorted(s.items(), key=lambda kv: -kv[1])]
        return "\n".join(lines)


PROFILER = FrameProfiler()
