"""Procedural synthetic scenes (numpy copy of
volsurfs_tpu/datasets/synthetic.py: the sphere scene and the "hard" scene).

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


# ---- "hard" scene: thin features, a concavity, high-frequency albedo and
# strong view-dependent shading. The multi-sphere-style smooth scene
# saturates ~23.5 dB across all pipeline stages and cannot detect
# per-stage quality loss; this one is built to expose
# it: a 0.02-thick torus ring and three 0.016-thick fins stress mesh
# extraction + simplification, the crater stresses occupancy/visibility,
# sin-product albedo stresses texture resolution, and a Phong lobe
# stresses the SH view dependence. Ground truth is rendered by marching
# the exact CSG SDF with conservative steps + bisection to 1e-6 (offline
# numpy — exactness matters, speed does not).


def _hard_sdf(p):
    """Exact-ish CSG SDF of the hard scene. p [N, 3] -> [N]."""
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    r = np.linalg.norm(p, axis=-1)
    body = r - 0.35
    crater = np.linalg.norm(p - np.asarray([0.20, 0.16, 0.12]), axis=-1) - 0.16
    body = np.maximum(body, -crater)  # concavity

    # thin torus ring in the xz plane
    ring_r = np.sqrt(x * x + z * z) - 0.46
    torus = np.sqrt(ring_r * ring_r + y * y) - 0.020

    # three thin fins (rotated boxes, thin along z')
    sdf = np.minimum(body, torus)
    for ang in (0.3, 2.4, 4.5):
        ca, sa = np.cos(ang), np.sin(ang)
        xr = ca * x + sa * z
        zr = -sa * x + ca * z
        q = np.stack(
            [np.abs(xr) - 0.52, np.abs(y) - 0.10, np.abs(zr) - 0.008], -1
        )
        box = np.linalg.norm(np.maximum(q, 0.0), axis=-1) + np.minimum(
            np.max(q, axis=-1), 0.0
        )
        sdf = np.minimum(sdf, box)
    return sdf


def _hard_normal(p, eps=5e-5):
    n = np.stack(
        [
            _hard_sdf(p + np.asarray([eps, 0, 0])) - _hard_sdf(p - np.asarray([eps, 0, 0])),
            _hard_sdf(p + np.asarray([0, eps, 0])) - _hard_sdf(p - np.asarray([0, eps, 0])),
            _hard_sdf(p + np.asarray([0, 0, eps])) - _hard_sdf(p - np.asarray([0, 0, eps])),
        ],
        -1,
    )
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


def render_hard_scene(camera: Camera):
    """Analytic render of the hard CSG scene (white bg).

    Marching uses 0.6x conservative steps (CSG subtraction SDFs are only
    distance bounds) with sign-crossing bisection, so GT geometry is exact
    to ~1e-6 — far below pixel footprint at any tested resolution.
    """
    H, W = camera.height, camera.width
    fx, fy = camera.intrinsics[0, 0], camera.intrinsics[1, 1]
    cx, cy = camera.intrinsics[0, 2], camera.intrinsics[1, 2]
    jj, ii = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5, indexing="xy")
    xpix = (jj - cx) / fx
    ypix = (ii - cy) / fy
    dirs_cam = np.stack([xpix, ypix, np.ones_like(xpix)], -1)
    R = camera.pose[:3, :3]
    dirs = (dirs_cam @ R.T).reshape(-1, 3)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = np.broadcast_to(camera.pose[:3, 3], dirs.shape).astype(np.float64)

    # enter at the bounding sphere r=0.85 (scene fits inside)
    b = np.sum(o * dirs, -1)
    c = np.sum(o * o, -1) - 0.85**2
    disc = b * b - c
    may_hit = disc > 0
    t = np.where(may_hit, -b - np.sqrt(np.maximum(disc, 0.0)), np.inf)
    t_exit = np.where(may_hit, -b + np.sqrt(np.maximum(disc, 0.0)), -np.inf)

    # march only the still-active subset each step (the fg fraction is ~0.16
    # and most rays resolve in a few dozen steps; evaluating the CSG SDF over
    # all H*W rays x 400 steps made GT generation ~25 s/frame at 256²)
    hit = np.zeros(t.shape, bool)
    t_hit = np.zeros_like(t)
    idx = np.nonzero(may_hit)[0]
    t_cur = t[idx]
    t_ex = t_exit[idx]
    oa, da = o[idx], dirs[idx]
    prev_t = t_cur.copy()
    prev_s = np.full_like(t_cur, np.inf)
    for _ in range(400):
        if idx.size == 0:
            break
        s = _hard_sdf(oa + t_cur[:, None] * da)
        crossed = (s < 0) & np.isfinite(prev_s)
        if crossed.any():
            # bisection refine within [prev_t, t_cur]
            lo, hi = prev_t[crossed], t_cur[crossed]
            oc, dc = oa[crossed], da[crossed]
            for _ in range(40):
                mid = 0.5 * (lo + hi)
                sm = _hard_sdf(oc + mid[:, None] * dc)
                neg = sm < 0
                hi = np.where(neg, mid, hi)
                lo = np.where(neg, lo, mid)
            t_hit[idx[crossed]] = 0.5 * (lo + hi)
            hit[idx[crossed]] = True
        t_next = t_cur + np.maximum(0.6 * s, 1.5e-4)
        keep = ~crossed & (t_next <= t_ex)
        idx, oa, da, t_ex = idx[keep], oa[keep], da[keep], t_ex[keep]
        prev_t, prev_s = t_cur[keep], s[keep]
        t_cur = t_next[keep]

    p = o + t_hit[:, None] * dirs
    n = _hard_normal(p)

    # high-frequency procedural albedo + lambert + view-dependent specular
    stripes = 0.5 + 0.5 * np.sin(34.0 * p[:, 0]) * np.sin(
        30.0 * p[:, 1] + 2.0 * np.sin(8.0 * p[:, 2])
    )
    checker = 0.5 + 0.5 * np.sign(
        np.sin(22.0 * p[:, 0]) * np.sin(22.0 * p[:, 2])
    )
    albedo = np.stack(
        [
            0.15 + 0.75 * stripes,
            0.25 + 0.55 * checker,
            0.85 - 0.55 * stripes * checker,
        ],
        -1,
    )
    light = np.asarray([0.48, 0.6, 0.64])
    light = light / np.linalg.norm(light)
    lamb = np.maximum(np.sum(n * light, -1), 0.0)
    v = -dirs
    refl = 2.0 * np.sum(n * light, -1, keepdims=True) * n - light
    spec = np.maximum(np.sum(refl * v, -1), 0.0) ** 32
    rgb = albedo * (0.25 + 0.75 * lamb)[:, None] + 0.55 * spec[:, None]
    rgb = np.clip(np.where(hit[:, None], rgb, 1.0), 0.0, 1.0).astype(np.float32)
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
    """Cameras + analytic images of a procedural scene ("sphere" or "hard").

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
        if scene == "hard":
            rgb, mask = render_hard_scene(cam)
        else:
            rgb, mask = render_sphere_scene(cam, sphere_radius)
        rgbs.append(rgb)
        masks.append(mask)
    return cams, np.stack(rgbs), np.stack(masks)
