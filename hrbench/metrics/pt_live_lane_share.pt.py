"""100 x the lanes live into each bounce over the width each bounce ran,
summed over the bounces of the traced frames (the path tracer's counters,
kept by the program's tracer for the frames a torch.profiler session
recorded), %. None where the program keeps no such counters."""


def read(ctx):
    from hobbyrenderer_tpu_torch.utils.timing import PROFILER
    live = width = 0
    for f in getattr(PROFILER, "frames", ()):
        if not f.profiled:
            continue
        counts = f.counts()
        live += sum(v for k, v in counts.items() if k.startswith("pt_live_"))
        width += sum(v for k, v in counts.items() if k.startswith("pt_width_"))
    return 100.0 * live / width if width else None
