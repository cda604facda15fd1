"""The window arithmetic: a frame counts whole or not at all, and every rate
and time is taken over the work completed and the time it took."""

import time

import pytest

from hrbench import run as hr
from hrbench.window import Window, rate_per_s


class _Dev:
    type = "cpu"


class _Renderer:
    """Frames of a fixed host time, like a renderer that waits for nothing."""

    device = _Dev()

    def __init__(self, frame_s):
        self.frame_s = frame_s
        self.starts = []

    def render_frame(self, dt):
        self.starts.append(time.perf_counter())
        time.sleep(self.frame_s)

    def synchronize(self):
        pass


class _Traffic:
    moves = False
    dt = 1 / 60


class _Capture:
    armed = False
    frame_no = -1


def test_partial_last_frame_never_enters_the_rate():
    r = _Renderer(0.05)
    w = hr.run_window(r, _Traffic(), 0.22, 0, _Capture(), 0)
    # frames start at about 0, .05, .10, .15, .20: the fifth starts before the
    # deadline and is counted whole, with the time it took to finish
    assert w.frames == 5
    assert r.starts[-1] - w.t_start < 0.22
    assert w.t_end - w.t_start >= 0.25
    assert w.work == 5
    assert rate_per_s(w._replace(work=500.0)) == pytest.approx(500.0 / w.seconds)
    # never over the nominal seconds: the 0.22 s never enters
    assert rate_per_s(w._replace(work=500.0)) < 500.0 / 0.22


def test_window_takes_at_least_the_checked_frames():
    w = hr.run_window(_Renderer(0.01), _Traffic(), 0.0, 0, _Capture(), 2)
    assert w.frames == hr.CHECK_FRAMES


def test_the_rate_is_the_work_done_over_the_time_taken():
    w = Window(0.0, 3.0, 4, [1.0, 2.0, 3.0, 4.0], 8.0)
    assert rate_per_s(w) == pytest.approx(8.0 / 3.0)
    # a frame that walked half its lanes counts half its samples
    assert rate_per_s(w._replace(work=6.0)) == pytest.approx(6.0 / 3.0)


def test_a_window_with_no_frame_has_no_rate():
    with pytest.raises(ValueError):
        rate_per_s(Window(0.0, 1.0, 0, [], 1.0))
