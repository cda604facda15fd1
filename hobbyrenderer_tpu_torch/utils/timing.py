"""The port's tracer (observability layer): named spans of the frame, the
host syncs counted per span, and the program's per-frame counters.

Reference: microprofile CPU/GPU scopes + per-pass timer queries
(src/RenderGraph.cpp:329-349) shown in the ImGui timing table.

- ``PROFILER.span(name)`` times its body on the host clock and opens a
  ``torch.profiler.record_function`` of the same name, so that a profiler
  session sees the span on the clock of the device's operations (the
  device-side range covers the work launched inside it). Spans nest. Inside
  a frame their host ms sum per name into ``history`` (one dict a frame:
  ``summary()``, ``table()``, the CLI's ``--timings``); outside one (the
  Renderer's set-up) into ``setup``.
- ``PROFILER.frame()`` brackets one frame. A frame is traced while a
  torch.profiler session records or ``enabled`` is set (the CLI's
  ``--timings``). A traced frame runs under
  ``torch.cuda.set_sync_debug_mode("warn")``: each sync warning is counted
  into the innermost open span (``note_sync``) and not shown. It keeps a
  ``FrameRecord`` in ``frames``: its spans (name, parent, host ms, syncs)
  and the counts the program hands in (``count``), device tensors left on
  the device until ``FrameRecord.counts()`` reads them. An untraced frame
  keeps its host ms in ``history`` and nothing else."""

from __future__ import annotations

import contextlib
import time
import warnings
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

# the warning of torch's sync-debug mode "warn" (c10/cuda/CUDAFunctions.cpp)
SYNC_WARNING = "called a synchronizing CUDA operation"


@dataclass
class SpanRecord:
    name: str
    parent: Optional[str]       # the enclosing span's name (None at the frame's top)
    host_ms: float = 0.0
    syncs: int = 0              # host syncs inside this span and not in a child


@dataclass
class FrameRecord:
    index: int                  # the frame's position in ``history``
    profiled: bool              # a torch.profiler session recorded the frame
    spans: List[SpanRecord] = field(default_factory=list)
    syncs_outside: int = 0      # host syncs of the frame outside every span
    host_counts: Dict[str, int] = field(default_factory=dict)
    device_counts: List[Tuple[Sequence[str], torch.Tensor]] = field(default_factory=list)

    @property
    def host_syncs(self) -> int:
        return self.syncs_outside + sum(s.syncs for s in self.spans)

    def counts(self) -> Dict[str, int]:
        """Every count of the frame by name; the device's are copied to the
        host here (a sync)."""
        out = dict(self.host_counts)
        for names, values in self.device_counts:
            out.update(zip(names, values.tolist()))
        return out


class FrameProfiler:
    """Spans, host syncs and counters of the frames; like the reference's
    SimpleTimer + timing table."""

    def __init__(self):
        self.enabled = False    # trace every frame (the CLI's --timings)
        self.scopes: Dict[str, float] = defaultdict(float)
        self.history: List[Dict[str, float]] = []
        self.setup: Dict[str, float] = defaultdict(float)
        self.frames: List[FrameRecord] = []
        self._in_frame = False
        self._frame: Optional[FrameRecord] = None     # the open frame, when traced
        self._stack: List[SpanRecord] = []

    @contextlib.contextmanager
    def span(self, name: str):
        rec = None
        if self._frame is not None:
            rec = SpanRecord(name, self._stack[-1].name if self._stack else None)
            self._frame.spans.append(rec)
            self._stack.append(rec)
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            ms = (time.perf_counter() - t0) * 1000.0
            (self.scopes if self._in_frame else self.setup)[name] += ms
            if rec is not None:
                rec.host_ms = ms
                self._stack.pop()

    scope = span

    def note_sync(self):
        """One host sync of the traced frame, counted into the innermost open
        span (the sync-debug warning's hook)."""
        if self._frame is None:
            return
        if self._stack:
            self._stack[-1].syncs += 1
        else:
            self._frame.syncs_outside += 1

    def count(self, names: Sequence[str], values):
        """Per-frame counts of the program, kept by a traced frame only:
        ``values`` an int64 device tensor with one value a name (left on the
        device), or host ints."""
        if self._frame is None:
            return
        if isinstance(values, torch.Tensor):
            self._frame.device_counts.append((tuple(names), values))
        else:
            self._frame.host_counts.update(zip(names, (int(v) for v in values)))

    @contextlib.contextmanager
    def frame(self):
        """One frame; ``end_frame`` at its end."""
        profiled = bool(torch.autograd.profiler._is_profiler_enabled)
        self._in_frame = True
        if self.enabled or profiled:
            self._frame = FrameRecord(len(self.history), profiled)
            self.frames.append(self._frame)
        try:
            with self._counting_syncs() if self._frame is not None else contextlib.nullcontext():
                yield
        finally:
            self._in_frame = False
            self._frame = None
            self._stack = []
            self.end_frame()

    @contextlib.contextmanager
    def _counting_syncs(self):
        cuda = torch.cuda.is_available()
        with warnings.catch_warnings():
            warnings.filterwarnings("always", message=SYNC_WARNING)
            shown = warnings.showwarning

            def show(message, category, filename, lineno, file=None, line=None):
                if SYNC_WARNING in str(message):
                    self.note_sync()
                else:
                    shown(message, category, filename, lineno, file, line)
            warnings.showwarning = show
            prev = torch.cuda.get_sync_debug_mode() if cuda else 0
            if cuda:
                torch.cuda.set_sync_debug_mode(max(prev, 1))   # "error" stays "error"
            try:
                yield
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(prev)

    def end_frame(self):
        self.history.append(dict(self.scopes))
        self.scopes = defaultdict(float)

    def summary(self, last_n: int = 16) -> Dict[str, float]:
        if not self.history:
            return {}
        hist = self.history[-last_n:]
        keys = set().union(*hist)
        return {k: sum(h.get(k, 0.0) for h in hist) / len(hist) for k in sorted(keys)}

    def sync_summary(self, last_n: int = 16) -> Dict[str, float]:
        """Host syncs a frame by span over the last ``last_n`` traced frames
        ("(outside spans)" for the rest of the frame)."""
        recs = self.frames[-last_n:]
        out: Dict[str, float] = defaultdict(float)
        for f in recs:
            for s in f.spans:
                out[s.name] += s.syncs / len(recs)
            out["(outside spans)"] += f.syncs_outside / len(recs)
        return dict(out)

    def table(self, last_n: int = 16) -> str:
        s = self.summary(last_n)
        if not s:
            return "(no timing data)"
        syncs = self.sync_summary(last_n)
        width = max(len(k) for k in list(s) + list(syncs) + list(self.setup))
        lines = [f"{k:<{width}}  {v:8.3f} ms" + (f"  {syncs.get(k, 0.0):6.1f} syncs"
                                                 if syncs else "")
                 for k, v in sorted(s.items(), key=lambda kv: -kv[1])]
        if syncs.get("(outside spans)"):
            lines.append(f"{'(outside spans)':<{width}}  {'':>11}  "
                         f"{syncs['(outside spans)']:6.1f} syncs")
        if self.setup:
            lines.append("Set-up:")
            lines += [f"{k:<{width}}  {v:8.3f} ms" for k, v in self.setup.items()]
        return "\n".join(lines)


PROFILER = FrameProfiler()
