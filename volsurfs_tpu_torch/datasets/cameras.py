"""Cameras and ray generation (numpy copy of volsurfs_tpu/datasets/cameras.py,
whose ray functions use JAX). Poses are OpenCV-convention camera-to-world
(x right, y down, z forward).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Camera:
    """Pinhole camera: intrinsics [3,3], camera-to-world pose [4,4] (OpenCV)."""

    intrinsics: np.ndarray  # [3, 3]
    pose: np.ndarray  # [4, 4] camera-to-world
    width: int
    height: int
    camera_id: int = 0


def get_camera_rays(camera: Camera):
    """All rays of a camera through the pixel centers, row-major over pixels.

    Returns (rays_o [H*W, 3], rays_d [H*W, 3]) as float32 numpy arrays.
    """
    H, W = camera.height, camera.width
    jj, ii = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy"
    )
    pix = np.stack([jj.reshape(-1), ii.reshape(-1)], axis=-1) + np.float32(0.5)
    return rays_from_pixels(
        np.asarray(camera.intrinsics, np.float32), np.asarray(camera.pose, np.float32), pix
    )


def rays_from_pixels(intrinsics, pose, pixels):
    """Rays through (sub)pixel coordinates [N, 2] (x, y)."""
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    x = (pixels[:, 0] - cx) / fx
    y = (pixels[:, 1] - cy) / fy
    dirs_cam = np.stack([x, y, np.ones_like(x)], axis=-1)
    dirs_world = dirs_cam @ pose[:3, :3].T
    dirs_world = dirs_world / np.linalg.norm(dirs_world, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(pose[:3, 3], dirs_world.shape)
    return np.ascontiguousarray(rays_o, np.float32), dirs_world.astype(np.float32)


def look_at_pose(eye, target=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """OpenCV c2w pose looking from eye to target."""
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-6:
        right = np.cross(fwd, np.asarray([0.0, 1.0, 0.0], np.float32))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0] = right
    pose[:3, 1] = down
    pose[:3, 2] = fwd
    pose[:3, 3] = eye
    return pose


def sample_cameras_on_hemisphere(
    nr_cameras: int,
    radius: float,
    intrinsics: np.ndarray,
    width: int,
    height: int,
    full_sphere: bool = False,
    seed: int = 0,
):
    """Cameras on a (hemi)sphere looking at the origin
    (mvdatasets.sample_cameras_on_hemisphere parity, reference
    trainer.py:133-148)."""
    rng = np.random.default_rng(seed)
    cams = []
    for i in range(nr_cameras):
        # fibonacci-ish deterministic spiral + jitter for coverage
        z = (i + 0.5) / nr_cameras
        if full_sphere:
            z = z * 2.0 - 1.0
        phi = i * np.pi * (3.0 - np.sqrt(5.0)) + rng.uniform(0, 1e-3)
        sin_t = np.sqrt(max(0.0, 1.0 - z * z))
        eye = radius * np.asarray(
            [np.cos(phi) * sin_t, np.sin(phi) * sin_t, z], np.float32
        )
        pose = look_at_pose(eye)
        cams.append(
            Camera(
                intrinsics=np.asarray(intrinsics, np.float32),
                pose=pose,
                width=width,
                height=height,
                camera_id=i,
            )
        )
    return cams
