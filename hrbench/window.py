"""Window arithmetic: what the end-to-end metrics are computed from.

A window starts at ``t_start`` (host clock) and takes frames while the
clock reads before ``t_start + seconds``: every frame started then is
finished and counted, and the window ends at ``t_end``, the host clock
after the device has finished the last of them. So every rate and time is
the work completed over the time it took; the nominal length only decides
which frames start."""

from __future__ import annotations

from typing import List, NamedTuple


class Window(NamedTuple):
    t_start: float          # host clock (s) at the window's start
    t_end: float            # host clock (s) after the last frame finished
    frames: int             # frames started before the deadline (all finished)
    frame_ms: List[float]   # each frame's own time, from device events
    work: float             # the work the frames completed (samples walked), or frames

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start


def rate_per_s(w: Window) -> float:
    """The work the completed frames did over the window's time, a second."""
    if w.frames < 1:
        raise ValueError("a window with no frame has no rate")
    return w.work / w.seconds
