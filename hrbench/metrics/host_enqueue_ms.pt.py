"""The program's host scope Frame/Render (the frame's enqueue on the host,
with no wait for the card), median over the window's frames, ms."""
import statistics


def read(ctx):
    vals = [f["Frame/Render"] for f in ctx.host_frames if "Frame/Render" in f]
    return statistics.median(vals) if vals else None
