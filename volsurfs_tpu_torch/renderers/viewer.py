"""Orbit camera for baked-scene frames (``OrbitCamera`` of
volsurfs_tpu/renderers/viewer.py; the interactive and turntable viewers are
not ported yet)."""

from __future__ import annotations

import numpy as np

from volsurfs_tpu_torch.datasets.cameras import Camera, look_at_pose


class OrbitCamera:
    """Azimuth/elevation/radius orbit around a center."""

    def __init__(self, width=800, height=800, radius=2.0, fovy_deg=45.0,
                 center=(0.0, 0.0, 0.0)):
        self.width = width
        self.height = height
        self.radius = radius
        self.azimuth = 0.0
        self.elevation = 0.3
        self.center = np.asarray(center, np.float32)
        f = 0.5 * height / np.tan(np.deg2rad(fovy_deg) / 2)
        self.intrinsics = np.asarray(
            [[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32
        )

    def rotate(self, d_azimuth: float, d_elevation: float):
        self.azimuth += d_azimuth
        self.elevation = float(np.clip(self.elevation + d_elevation, -1.45, 1.45))

    def zoom(self, factor: float):
        self.radius = float(np.clip(self.radius * factor, 0.2, 20.0))

    def pan(self, dx: float, dy: float):
        self.center = self.center + np.asarray([dx, dy, 0.0], np.float32)

    def camera(self) -> Camera:
        eye = self.center + self.radius * np.asarray(
            [
                np.cos(self.azimuth) * np.cos(self.elevation),
                np.sin(self.azimuth) * np.cos(self.elevation),
                np.sin(self.elevation),
            ],
            np.float32,
        )
        return Camera(
            intrinsics=self.intrinsics,
            pose=look_at_pose(eye, self.center),
            width=self.width,
            height=self.height,
        )
