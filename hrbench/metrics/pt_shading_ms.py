"""Kernel ms a frame inside the path tracer's 'PT bounce b' and 'PT compact
b' ranges, less the bvh16 walks (K3): the bounce shading and compaction."""
from hrbench.devtrace import kernel_ms_in


def read(ctx):
    if ctx.trace is None or not any(r[0].startswith("PT ") for r in ctx.trace.ranges):
        return None
    return kernel_ms_in(ctx.trace, lambda r: r.startswith(("PT bounce", "PT compact")),
                        lambda name: "bvh16_walk" not in name)
