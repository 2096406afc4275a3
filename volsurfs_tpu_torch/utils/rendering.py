"""Full-frame rendering and image saving (counterpart of
volsurfs_tpu/utils/rendering.py; PNGs are written by ``utils/png.py``, not
PIL)."""

from __future__ import annotations

import os

import numpy as np

from volsurfs_tpu_torch.utils import png


def save_image_png(img: np.ndarray, out_dir: str, name: str):
    """img [H, W], [H, W, 1] or [H, W, 3|4] in [0, 1] -> out_dir/name.png
    (clipped, scaled by 255 and rounded half to even, as JAX's)."""
    os.makedirs(out_dir, exist_ok=True)
    arr = np.asarray(img)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    arr = (np.clip(arr, 0.0, 1.0) * 255.0).round().astype(np.uint8)
    path = os.path.join(out_dir, name if name.endswith(".png") else name + ".png")
    png.write(path, arr)
    return path


def colorize_depth(depth: np.ndarray, near=None, far=None):
    d = np.asarray(depth)
    if d.ndim == 3:
        d = d[..., 0]
    near = near if near is not None else np.percentile(d[d > 0], 2) if (d > 0).any() else 0
    far = far if far is not None else np.percentile(d[d > 0], 98) if (d > 0).any() else 1
    t = np.clip((d - near) / max(far - near, 1e-9), 0, 1)
    # simple viridis-ish ramp without matplotlib
    r = np.clip(1.5 * t - 0.25, 0, 1)
    g = np.clip(1.5 * t, 0, 1) * (1 - 0.3 * t)
    b = np.clip(1.0 - 1.2 * t, 0, 1)
    return np.stack([r, g, b], -1)


def render_from_camera(trainer, camera, subsample_factor: int = 1):
    """Render a camera (optionally downscaled) through
    ``trainer.render_camera`` and return postprocessed buffers."""
    cam = camera.resize(subsample_factor) if subsample_factor > 1 else camera
    out = trainer.render_camera(cam)
    buffers = {"rgb": np.clip(out["rgb"], 0, 1)}
    if "depth" in out:
        buffers["depth"] = colorize_depth(out["depth"])
    for key in ("normals",):
        if key in out:
            buffers[key] = np.clip(out[key] * 0.5 + 0.5, 0, 1)
    return buffers


def render_cameras_and_save(trainer, cameras, out_dir: str, subsample_factor: int = 1):
    """Render cameras and save their PNG trees (out_dir/<buffer>/<id>.png)."""
    paths = []
    for cam in cameras:
        buffers = render_from_camera(trainer, cam, subsample_factor)
        for name, img in buffers.items():
            paths.append(
                save_image_png(img, os.path.join(out_dir, name), f"{cam.camera_id:03d}")
            )
    return paths
