"""Procedural synthetic scenes (numpy copy of the sphere scene of
volsurfs_tpu/datasets/synthetic.py; the "hard" scene is not copied yet).

The reference trains only on downloaded datasets (Blender/DTU/Shelly); this
framework additionally ships an analytic scene generator so the full training
pipeline is exercisable without any external data (SURVEY.md §4 test
strategy). Images are rendered analytically (exact ray-primitive
intersection + normal shading), so training has a well-defined optimum.
"""

from __future__ import annotations

import numpy as np

from volsurfs_tpu_torch.datasets.cameras import Camera, sample_cameras_on_hemisphere


def _ray_sphere(rays_o, rays_d, center, radius):
    oc = rays_o - center
    b = np.sum(oc * rays_d, axis=-1)
    c = np.sum(oc * oc, axis=-1) - radius**2
    disc = b * b - c
    hit = disc >= 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    t = np.where(hit & (t > 0), t, np.inf)
    return t


def render_sphere_scene(camera: Camera, radius: float = 0.5):
    """Analytic render: normal-shaded sphere at the origin, white background.

    Returns (rgb [H, W, 3] float32 in [0,1], mask [H, W, 1]).
    """
    H, W = camera.height, camera.width
    fx, fy = camera.intrinsics[0, 0], camera.intrinsics[1, 1]
    cx, cy = camera.intrinsics[0, 2], camera.intrinsics[1, 2]
    jj, ii = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5, indexing="xy")
    x = (jj - cx) / fx
    y = (ii - cy) / fy
    dirs_cam = np.stack([x, y, np.ones_like(x)], -1)
    R = camera.pose[:3, :3]
    dirs = dirs_cam @ R.T
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = np.broadcast_to(camera.pose[:3, 3], dirs.shape)

    t = _ray_sphere(o.reshape(-1, 3), dirs.reshape(-1, 3), np.zeros(3), radius)
    hit = np.isfinite(t)
    t_safe = np.where(hit, t, 0.0)
    p = o.reshape(-1, 3) + t_safe[:, None] * dirs.reshape(-1, 3)
    n = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-9)
    rgb = np.where(hit[:, None], n * 0.5 + 0.5, 1.0).astype(np.float32)
    mask = hit[:, None].astype(np.float32)
    return rgb.reshape(H, W, 3), mask.reshape(H, W, 1)


def make_synthetic_split(
    nr_cameras: int = 16,
    width: int = 64,
    height: int = 64,
    cam_radius: float = 2.0,
    sphere_radius: float = 0.5,
    seed: int = 0,
    scene: str = "sphere",
):
    """Cameras + analytic images of the procedural sphere scene.

    Returns (cameras list, rgbs [N, H, W, 3], masks [N, H, W, 1]).
    """
    f = 0.5 * width / np.tan(0.4)  # ~45 deg fov
    intrinsics = np.asarray(
        [[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32
    )
    cams = sample_cameras_on_hemisphere(
        nr_cameras, cam_radius, intrinsics, width, height, full_sphere=True, seed=seed
    )
    rgbs, masks = [], []
    for cam in cams:
        if scene != "sphere":
            raise ValueError(f"scene {scene!r} is not ported to torch yet")
        rgb, mask = render_sphere_scene(cam, sphere_radius)
        rgbs.append(rgb)
        masks.append(mask)
    return cams, np.stack(rgbs), np.stack(masks)
