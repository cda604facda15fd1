"""Device kernels (not copies or sets) in the traced frames, a frame."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.trace.frames
