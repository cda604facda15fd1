"""The pass graph: declared-access composition of passes into one frame.

Counterpart of hobbyrenderer_tpu/graph/rendergraph.py. The JAX graph traces
every pass into one jitted function and donates the persistent state; here
PyTorch runs each pass eagerly, in order, so the graph keeps only its declared
API:
- a named pass registry with per-pass enable toggles,
- declared reads/writes validated as the pass runs (undeclared access and
  read-before-write raise AccessError),
- persistent resources carried across frames in one FrameState dict that the
  graph updates in place (the dict, not the tensors: passes are functional
  and never write into a tensor they were given, so a pass that stores one
  tensor under two names — TAA's hdr and taa_history — cannot have either
  overwritten by a later pass),
- execute_per_pass(): the same frame with a device synchronize after each
  pass and each pass timed (``last_pass_timings``),
- describe() and export_json(): the pass/resource schedule, the latter with
  each resource's shape from the last run."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Sequence, Set

import torch

from hobbyrenderer_tpu_torch.utils.timing import PROFILER


@dataclass
class FrameContext:
    """Per-frame inputs available to every pass."""

    gpu: Any                  # SceneGPU
    vc: Dict[str, Any]        # view constants (torch tensors on the device)
    settings: Any             # RenderSettings (python scalars)
    dt: float = 1.0 / 60.0
    rt: Any = None            # SceneRT for ray-traced passes


class AccessError(RuntimeError):
    pass


def _describe_value(v) -> Any:
    """Compact shape/dtype summary of a resource: one string for a tensor,
    a list for a tuple of them, repr for anything else."""
    if isinstance(v, torch.Tensor):
        return f"{tuple(v.shape)}:{str(v.dtype).replace('torch.', '')}"
    if isinstance(v, (tuple, list)):
        descs = [_describe_value(x) for x in v]
        return descs[0] if len(descs) == 1 else descs
    return repr(v)


class _GuardedResources:
    """Dict wrapper enforcing declared reads/writes."""

    def __init__(self, store: Dict[str, Any], reads: Set[str], writes: Set[str],
                 pass_name: str):
        self._store = store
        self._reads = reads
        self._writes = writes
        self._pass = pass_name
        self.written: Dict[str, Any] = {}

    def __getitem__(self, key: str):
        if key not in self._reads and key not in self._writes:
            raise AccessError(
                f"pass '{self._pass}' reads undeclared resource '{key}' "
                f"(declared reads={sorted(self._reads)})")
        if key in self.written:
            return self.written[key]
        if key not in self._store:
            raise AccessError(
                f"pass '{self._pass}' reads '{key}' before any pass wrote it")
        return self._store[key]

    def __setitem__(self, key: str, value):
        if key not in self._writes:
            raise AccessError(
                f"pass '{self._pass}' writes undeclared resource '{key}' "
                f"(declared writes={sorted(self._writes)})")
        self.written[key] = value


@dataclass
class RenderPass:
    """One pass: name + declared access + fn(ctx, res)."""

    name: str
    fn: Callable[[FrameContext, _GuardedResources], None]
    reads: Set[str] = field(default_factory=set)
    writes: Set[str] = field(default_factory=set)
    persistent: Set[str] = field(default_factory=set)
    enabled: bool = True


def render_pass(name: str, reads: Sequence[str] = (), writes: Sequence[str] = (),
                persistent: Sequence[str] = ()):
    """Decorator: @render_pass("Bloom", reads=[...], writes=[...])."""

    def deco(fn):
        return RenderPass(name=name, fn=fn, reads=set(reads), writes=set(writes),
                          persistent=set(persistent))

    return deco


class RenderGraph:
    """Runs passes in order over a resource store seeded by the FrameState."""

    def __init__(self):
        self.passes: List[RenderPass] = []
        self.last_run_log: List[Dict[str, Any]] = []
        self.last_pass_timings: List[Dict[str, Any]] = []

    def add(self, p: RenderPass):
        if any(q.name == p.name for q in self.passes):
            raise ValueError(f"duplicate pass '{p.name}'")
        self.passes.append(p)
        return p

    def get(self, name: str) -> RenderPass:
        for p in self.passes:
            if p.name == name:
                return p
        raise KeyError(name)

    @property
    def persistent_names(self) -> Set[str]:
        names: Set[str] = set()
        for p in self.passes:
            names |= p.persistent
        return names

    def execute(self, ctx: FrameContext, frame_state: Dict[str, Any],
                outputs: Sequence[str]) -> Dict[str, Any]:
        """Run all enabled passes. ``frame_state`` seeds the persistent
        resources and is updated in place with their new values; returns the
        requested outputs."""
        return self._run(ctx, frame_state, outputs, None)

    def execute_per_pass(self, ctx: FrameContext, frame_state: Dict[str, Any],
                         outputs: Sequence[str]) -> Dict[str, Any]:
        """execute(), with each pass waited for and timed on its own: CUDA
        events around the pass and a synchronize on the card, the host clock
        on the CPU. The timings land in ``last_pass_timings`` [{pass, ms}];
        what each pass computes is unchanged."""
        timings = []

        def timed(name, run):
            if ctx.gpu.device.type == "cuda":
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                run()
                e1.record()
                e1.synchronize()
                ms = e0.elapsed_time(e1)
            else:
                t0 = time.perf_counter()
                run()
                ms = (time.perf_counter() - t0) * 1e3
            timings.append({"pass": name, "ms": ms})

        result = self._run(ctx, frame_state, outputs, timed)
        self.last_pass_timings = timings
        return result

    def _run(self, ctx, frame_state, outputs, around):
        store: Dict[str, Any] = dict(frame_state)
        log: List[Dict[str, Any]] = []
        for p in self.passes:
            if not p.enabled:
                log.append({"pass": p.name, "enabled": False})
                continue
            guard = _GuardedResources(store, set(p.reads), set(p.writes), p.name)

            def run(p=p, guard=guard):
                # the pass's span: its host ms and syncs, its ops' range in traces
                with PROFILER.span(p.name):
                    p.fn(ctx, guard)
            if around is None:
                run()
            else:
                around(p.name, run)
            missing = p.writes - set(guard.written) - set(store)
            if missing:
                raise AccessError(
                    f"pass '{p.name}' declared writes {sorted(missing)} "
                    f"but never wrote them")
            store.update(guard.written)
            log.append({"pass": p.name, "enabled": True, "wrote": sorted(guard.written),
                        "shapes": {k: _describe_value(v) for k, v in guard.written.items()}})
        self.last_run_log = log
        result = {}
        for name in outputs:
            if name not in store:
                raise AccessError(f"requested output '{name}' was never written")
            result[name] = store[name]
        frame_state.update({k: store[k] for k in self.persistent_names
                            if k in store})
        return result

    def describe(self) -> str:
        """RenderGraphUI-style dump of the pass/resource schedule."""
        lines = []
        for p in self.passes:
            flag = " " if p.enabled else "x"
            lines.append(f"[{flag}] {p.name:24s} reads={sorted(p.reads)} "
                         f"writes={sorted(p.writes)} persistent={sorted(p.persistent)}")
        return "\n".join(lines)

    def export_json(self) -> Dict[str, Any]:
        """Machine-readable graph dump: schedule order, declared access,
        enable state, each resource's shape and dtype from the last run, and
        each pass's ms from the last execute_per_pass run."""
        shape_of: Dict[str, Any] = {}
        for entry in self.last_run_log:
            shape_of.update(entry.get("shapes", {}))
        ms_of = {t["pass"]: t["ms"] for t in self.last_pass_timings}
        passes = []
        for i, p in enumerate(self.passes):
            passes.append({"order": i, "name": p.name, "enabled": p.enabled,
                           "reads": sorted(p.reads), "writes": sorted(p.writes),
                           "persistent": sorted(p.persistent),
                           **({"device_ms": round(ms_of[p.name], 3)}
                              if p.name in ms_of else {})})
        return {"passes": passes, "resources": shape_of}
