"""The one traffic generator: reads a mix's parameters from
``traffic/<name>.json`` and turns them, with ``--seed``, into what the
renderer is handed: the camera of every frame and the frame step ``dt``.

Parameters (every key of a mix's file):

- ``camera``: ``{"path": "orbit", "radius", "height", "target", "start_deg":
  [lo, hi], "deg_per_frame"}``: a camera on a circle about the y axis at
  ``radius`` and ``height``, looking at ``target``; the seed draws the start
  angle from [lo, hi) and the camera turns ``deg_per_frame`` every frame (0:
  it never moves, so the path tracer accumulates without a reset).
- ``dt``: seconds a frame of scene time.
- ``accumulation`` (optional): ``"restart_every_frame"`` where the scene
  moves under a still camera, so that each frame is an image of its own;
  without it the path tracer's average restarts only where the camera
  moves. ``accumulated_before`` turns this into the frames that the
  checked frame's average holds before it.

The seed never changes the scene; only the camera's angle."""

from __future__ import annotations

import json
import math
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str, root: str = os.path.dirname(HERE)) -> dict:
    """The mix ``traffic/<name>.json`` of the harness in checkout ``root``."""
    with open(os.path.join(root, os.path.basename(HERE), "traffic", name + ".json")) as f:
        return json.load(f)


class Traffic:
    def __init__(self, params: dict, seed: int):
        self.p = params
        self.rng = np.random.default_rng(seed)
        cam = params["camera"]
        lo, hi = cam["start_deg"]
        self.start_deg = float(self.rng.uniform(lo, hi))
        self.dt = float(params["dt"])
        acc = params.get("accumulation")
        if acc not in (None, "restart_every_frame"):
            raise ValueError(f"unknown accumulation '{acc}' (restart_every_frame)")
        self.restarts_every_frame = acc == "restart_every_frame"

    @property
    def moves(self) -> bool:
        return float(self.p["camera"]["deg_per_frame"]) != 0.0

    def accumulated_before(self, frame: int) -> int:
        """The frames since the accumulation last restarted, before frame
        ``frame`` (0 = the first warm-up frame): none where the camera moves
        or the mix restarts every frame, else every frame before it."""
        return 0 if self.moves or self.restarts_every_frame else frame

    def camera_pose(self, frame: int):
        """(position (3,), target (3,)) of frame ``frame`` (0 = the first
        warm-up frame)."""
        cam = self.p["camera"]
        a = math.radians(self.start_deg + frame * float(cam["deg_per_frame"]))
        r = float(cam["radius"])
        pos = np.asarray([r * math.sin(a), float(cam["height"]), r * math.cos(a)], np.float32)
        return pos, np.asarray(cam["target"], np.float32)
