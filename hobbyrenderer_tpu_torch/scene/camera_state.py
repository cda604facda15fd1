"""Per-scene camera persistence.

Reference: src/CameraStateManager.{h,cpp} — the render thread publishes a
spinlocked pending state; a 1 Hz background worker diffs and writes
camera_state.json; restored on scene load (src/Renderer.cpp:399-413).

TPU build: same contract, simpler machinery — a background thread wakes at
1 Hz, compares the last published state with what it last wrote, and saves.
(The host is not under a real-time constraint, so a lock suffices.)"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional


class CameraStateManager:
    def __init__(self, path: str = "camera_state.json", interval_s: float = 1.0):
        self.path = path
        self.interval_s = interval_s
        self._lock = threading.Lock()
        self._pending: Optional[dict] = None
        self._written: Optional[dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- render-thread side ---------------------------------------------------

    def publish(self, camera, scene_key: str = "default"):
        """Record the camera's state (cheap; called every frame)."""
        state = {
            "position": [float(x) for x in camera.position],
            "yaw": float(camera.yaw),
            "pitch": float(camera.pitch),
            "fov_y": float(camera.fov_y),
        }
        with self._lock:
            self._pending = {"scene": scene_key, "camera": state}

    def restore(self, camera, scene_key: str = "default") -> bool:
        """Apply a previously saved state if one exists for this scene."""
        try:
            with open(self.path) as f:
                data = json.load(f)
        except Exception:
            return False
        entry = data.get(scene_key)
        if not entry:
            return False
        import numpy as np
        camera.position = np.asarray(entry["position"], np.float32)
        camera.yaw = float(entry["yaw"])
        camera.pitch = float(entry["pitch"])
        camera.fov_y = float(entry.get("fov_y", camera.fov_y))
        return True

    # -- worker side ----------------------------------------------------------

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def stop(self, flush: bool = True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if flush:
            self._save_if_dirty()

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self._save_if_dirty()

    def _save_if_dirty(self):
        with self._lock:
            pending = self._pending
        if pending is None or pending == self._written:
            return
        data = {}
        try:
            with open(self.path) as f:
                data = json.load(f)
        except Exception:
            pass
        data[pending["scene"]] = pending["camera"]
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1)
        os.replace(tmp, self.path)
        self._written = pending
