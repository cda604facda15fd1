"""Fly camera + per-frame view constants.

Reference: src/Camera.{h,cpp} — WASD+mouse fly camera, reversed-Z infinite-far
perspective, EV100 exposure params, TAA jitter (m_PixelOffset), and
FillPlanarViewConstants producing the 10-matrix PlanarViewConstants block
(src/shaders/Common.sr:17-43).

TPU design: the camera is host state; ``view_constants()`` emits a dict-of-arrays
pytree passed into the jitted frame function (the uniform-buffer analogue)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from hobbyrenderer_tpu_torch.scene.scene import CameraDesc
from hobbyrenderer_tpu_torch.utils import math as hm


class Camera:
    def __init__(self, desc: Optional[CameraDesc] = None, width: int = 1920,
                 height: int = 1080):
        desc = desc or CameraDesc()
        self.position = np.asarray(desc.position, np.float32).copy()
        self.yaw = float(desc.yaw)       # radians, 0 = looking -Z
        self.pitch = float(desc.pitch)
        self.fov_y = float(desc.fov_y)
        self.znear = float(desc.znear)
        self.width = width
        self.height = height
        self.aperture_f = desc.aperture_f
        self.shutter_s = desc.shutter_s
        self.iso = desc.iso
        self.move_speed = 3.0
        self.look_speed = 0.003
        self.jitter_enabled = True
        self._frame_index = 0
        self._prev_view_proj_no_jitter = None

    # -- orientation ---------------------------------------------------------

    @property
    def forward(self) -> np.ndarray:
        cp, sp = np.cos(self.pitch), np.sin(self.pitch)
        cy, sy = np.cos(self.yaw), np.sin(self.yaw)
        return np.asarray([-sy * cp, sp, -cy * cp], np.float32)

    @property
    def right(self) -> np.ndarray:
        f = self.forward
        return np.asarray(hm.normalize(np.cross(f, [0.0, 1.0, 0.0])), np.float32)

    def update(self, dt: float, move=(0, 0, 0), look=(0, 0)):
        """move = (right, up, forward) in [-1,1]; look = (dx, dy) pixels."""
        self.yaw -= look[0] * self.look_speed
        self.pitch = float(np.clip(self.pitch - look[1] * self.look_speed,
                                   -1.55, 1.55))
        d = (self.right * move[0] + np.array([0, 1, 0], np.float32) * move[1]
             + self.forward * move[2])
        self.position = self.position + d * (self.move_speed * dt)

    def look_at(self, target):
        d = np.asarray(target, np.float32) - self.position
        self.pitch = float(np.arctan2(d[1], np.linalg.norm(d[[0, 2]])))
        self.yaw = float(np.arctan2(-d[0], -d[2]))

    # -- matrices ------------------------------------------------------------

    @property
    def aspect(self) -> float:
        return self.width / self.height

    def view_matrix(self) -> np.ndarray:
        return hm.look_at(self.position, self.position + self.forward, [0, 1, 0])

    def proj_matrix(self, jitter: Optional[np.ndarray] = None) -> np.ndarray:
        p = hm.perspective_reversed_z_infinite(self.fov_y, self.aspect, self.znear)
        if jitter is not None:
            # sub-pixel offset in NDC units (ref Camera m_PixelOffset)
            p = p.copy()
            p[0, 2] += 2.0 * jitter[0] / self.width
            p[1, 2] -= 2.0 * jitter[1] / self.height
        return p

    def current_jitter(self) -> np.ndarray:
        """Halton(2,3) jitter in [-0.5, 0.5] pixels (ref TAA jitter sequence)."""
        if not self.jitter_enabled:
            return np.zeros(2, np.float32)
        i = (self._frame_index % 16) + 1
        return np.asarray([float(hm.halton(np.asarray(i), 2)) - 0.5,
                           float(hm.halton(np.asarray(i), 3)) - 0.5], np.float32)

    def ev100(self) -> float:
        return hm.ev100_from_camera(self.aperture_f, self.shutter_s, self.iso)

    def view_constants(self, frame_index: Optional[int] = None) -> dict:
        """PlanarViewConstants analogue (ref Common.sr:17-43): jittered + no-jitter
        matrices, inverses, previous-frame matrix for motion vectors, viewport."""
        if frame_index is not None:
            self._frame_index = frame_index
        jit = self.current_jitter()
        V = self.view_matrix()
        P = self.proj_matrix(jit)
        P_nj = self.proj_matrix(None)
        VP = (P @ V).astype(np.float32)
        VP_nj = (P_nj @ V).astype(np.float32)
        prev = self._prev_view_proj_no_jitter if self._prev_view_proj_no_jitter is not None else VP_nj
        vc = {
            "view": V,
            "proj": P,
            "view_proj": VP,
            "view_proj_no_jitter": VP_nj,
            "prev_view_proj_no_jitter": prev.astype(np.float32),
            "inv_view": np.linalg.inv(V).astype(np.float32),
            "inv_proj": np.linalg.inv(P).astype(np.float32),
            "inv_view_proj": np.linalg.inv(VP).astype(np.float32),
            "camera_pos": self.position.astype(np.float32),
            "jitter": jit,
            "viewport": np.asarray([self.width, self.height], np.float32),
            "znear": np.float32(self.znear),
            "proj00": np.float32(P[0, 0]),
            "proj11": np.float32(P[1, 1]),
            "ev100": np.float32(self.ev100()),
            "frame_index": np.int32(self._frame_index),
        }
        return vc

    def end_frame(self):
        self._prev_view_proj_no_jitter = (self.proj_matrix(None) @ self.view_matrix()).astype(np.float32)
        self._frame_index += 1
