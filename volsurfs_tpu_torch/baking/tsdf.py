"""TSDF fusion: the background mesh from rendered depth maps (counterpart
of volsurfs_tpu/baking/tsdf.py, used by the baker's --extract_bg_mesh).

The depths are integrated into a truncated signed distance and weight grid
in host numpy, as the JAX package does; the zero level set is extracted by
``marching.marching_tetrahedra`` on ``device``.
"""

from __future__ import annotations

import numpy as np

from volsurfs_tpu_torch.baking.marching import marching_tetrahedra


class TSDFVolume:
    def __init__(self, resolution: int = 128, bounds: float = 1.0, trunc_voxels: float = 3.0,
                 device="cuda"):
        self.res = resolution
        self.bounds = bounds
        self.device = device
        self.voxel_size = 2.0 * bounds / (resolution - 1)
        self.trunc = trunc_voxels * self.voxel_size
        self.tsdf = np.ones((resolution,) * 3, np.float32)
        self.weights = np.zeros((resolution,) * 3, np.float32)
        lin = np.linspace(-bounds, bounds, resolution, dtype=np.float32)
        self._grid = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), axis=-1).reshape(-1, 3)

    def integrate(self, depth: np.ndarray, camera, depth_valid=None):
        """Fuse one depth map.

        Args:
          depth: [H, W] metric depth along the camera ray (z-depth).
          camera: datasets.cameras.Camera (OpenCV convention).
        """
        H, W = depth.shape[:2]
        K = camera.intrinsics
        w2c = np.linalg.inv(camera.pose)

        pts_cam = self._grid @ w2c[:3, :3].T + w2c[:3, 3]
        z = pts_cam[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = K[0, 0] * pts_cam[:, 0] / z + K[0, 2]
            v = K[1, 1] * pts_cam[:, 1] / z + K[1, 2]
        ui = np.round(u).astype(np.int64)
        vi = np.round(v).astype(np.int64)
        valid = (z > 1e-6) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        ui_c = np.clip(ui, 0, W - 1)
        vi_c = np.clip(vi, 0, H - 1)
        d = depth[vi_c, ui_c]
        if depth_valid is not None:
            valid &= depth_valid[vi_c, ui_c]
        valid &= d > 1e-6

        sdf = d - z  # positive in front of the surface
        within = valid & (sdf > -self.trunc)
        tsdf_obs = np.clip(sdf / self.trunc, -1.0, 1.0)

        flat_t = self.tsdf.reshape(-1)
        flat_w = self.weights.reshape(-1)
        w_old = flat_w[within]
        flat_t[within] = (flat_t[within] * w_old + tsdf_obs[within]) / (w_old + 1.0)
        flat_w[within] = w_old + 1.0

    def extract_mesh(self, min_weight: float = 1.0):
        """Marching tetrahedra on the fused TSDF (observed voxels only), on
        the volume's device."""
        field = np.where(self.weights >= min_weight, self.tsdf, 1.0)
        origin = np.full(3, -self.bounds, np.float64)
        spacing = np.full(3, self.voxel_size, np.float64)
        # negated: the TSDF is positive in front of the surface, the marching
        # takes negative inside
        return marching_tetrahedra(-field, origin, spacing, device=self.device)


def fuse_depths(depths, cameras, resolution: int = 128, bounds: float = 1.0, device="cuda"):
    """Fuse depth maps seen from cameras; returns (verts, faces)."""
    vol = TSDFVolume(resolution, bounds, device=device)
    for depth, cam in zip(depths, cameras):
        vol.integrate(np.asarray(depth), cam)
    return vol.extract_mesh()
