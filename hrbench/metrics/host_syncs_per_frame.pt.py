"""Host syncs a traced frame: the device-to-host syncs the program's tracer
counted in the frames a torch.profiler session recorded (the traced
frames), summed over each frame's spans, a frame. None where the program
has no such tracer."""


def read(ctx):
    from hobbyrenderer_tpu_torch.utils.timing import PROFILER
    frames = [f for f in getattr(PROFILER, "frames", ()) if f.profiled]
    if not frames:
        return None
    return sum(f.host_syncs for f in frames) / len(frames)
