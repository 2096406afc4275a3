"""Multi-view datasets (counterpart of volsurfs_tpu/datasets/mvdataset.py).

``MVDataset(dataset, scene, path, splits, config)`` holds per-split camera
and image lists:

- ``synthetic`` renders a procedural scene of ``synthetic.py`` ("sphere" or
  "hard"): the ``train`` split from seed 0 and the ``test`` split from seed
  1, cameras at radius 2;
- the blender family (``blender``, ``shelly``, ``blendernerf``, ``dmsr``)
  loads ``transforms_{split}.json`` and its PNGs; poses are scaled by
  ``pose_scale`` so the object fits the unit-ish bounding sphere;
- ``dtu`` loads an IDR-style scene (``image/*.png``, optional
  ``mask/*.png``, ``cameras.npz``); every ``test_camera_freq``-th camera is
  a test camera.

Images are read through ``utils/png.py`` (no PIL): 8-bit greyscale, RGB
and RGBA PNGs; any other image raises.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from volsurfs_tpu_torch.datasets import synthetic
from volsurfs_tpu_torch.datasets.cameras import Camera, opengl_to_opencv_pose
from volsurfs_tpu_torch.utils import png


@dataclasses.dataclass
class Split:
    cameras: list
    rgbs: np.ndarray  # [N, H, W, 3] float32
    masks: np.ndarray  # [N, H, W, 1] float32


class MVDataset:
    """dataset_name in {synthetic, blender, shelly, blendernerf, dmsr, dtu};
    splits dict of Split."""

    def __init__(
        self,
        dataset_name: str,
        scene_name: str,
        datasets_path: str,
        splits=("train", "test"),
        config: dict | None = None,
    ):
        config = config or {}
        self.dataset_name = dataset_name
        self.scene_name = scene_name
        self.splits: dict[str, Split] = {}
        self.scene_radius = float(config.get("scene_radius", 1.0))
        self.init_sphere_scale = float(config.get("init_sphere_scale", 0.3))
        self.bg_color = config.get("bg_color", None)

        if dataset_name == "synthetic":
            w = int(config.get("width", 64))
            h = int(config.get("height", 64))
            n_train = int(config.get("nr_train_cameras", 24))
            n_test = int(config.get("nr_test_cameras", 4))
            for split, n, seed in (("train", n_train, 0), ("test", n_test, 1)):
                if split not in splits:
                    continue
                cams, rgbs, masks = synthetic.make_synthetic_split(
                    n, w, h, cam_radius=2.0, sphere_radius=0.5, seed=seed, scene=scene_name,
                )
                self.splits[split] = Split(cams, rgbs, masks)
            self.bg_color = self.bg_color or "white"
        elif dataset_name in ("blender", "shelly", "blendernerf", "dmsr"):
            scene_path = os.path.join(datasets_path, dataset_name, scene_name)
            pose_scale = float(config.get("pose_scale", 0.25))
            subsample = int(config.get("subsample_factor", 1))
            test_skip = int(config.get("test_skip", 1))
            for split in splits:
                self.splits[split] = _load_blender_split(
                    scene_path, split, pose_scale, subsample,
                    test_skip if split == "test" else 1,
                )
            self.bg_color = self.bg_color or "white"
        elif dataset_name == "dtu":
            scene_path = os.path.join(datasets_path, dataset_name, scene_name)
            subsample = int(config.get("subsample_factor", 1))
            test_every = int(config.get("test_camera_freq", 8))
            all_split = _load_dtu_cameras(scene_path, subsample)
            n = len(all_split.cameras)
            test_ids = set(range(0, n, test_every))
            for split in splits:
                ids = sorted(test_ids) if split == "test" else [
                    i for i in range(n) if i not in test_ids
                ]
                self.splits[split] = Split(
                    [all_split.cameras[i] for i in ids],
                    all_split.rgbs[ids],
                    all_split.masks[ids],
                )
            self.scene_radius = float(
                config.get("scene_radius", 1.0)
            ) * float(config.get("scene_radius_mult", 1.0))
            self.bg_color = self.bg_color or "black"
        else:
            raise NotImplementedError(f"dataset {dataset_name} not supported yet")

    def __getitem__(self, split: str) -> Split:
        return self.splits[split]

    def has_masks(self) -> bool:
        return True


def _read_image(path: str) -> np.ndarray:
    """An 8-bit PNG as float32 [H, W, C] in [0, 1]."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: only PNG images are read (no PIL for other formats)")
    return png.read(path).astype(np.float32) / 255.0


def _load_blender_split(
    scene_path: str, split: str, pose_scale: float, subsample: int, skip: int
) -> Split:
    with open(os.path.join(scene_path, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    frames = meta["frames"][::skip]
    cams, rgbs, masks = [], [], []
    for i, frame in enumerate(frames):
        img_path = os.path.join(scene_path, frame["file_path"])
        if not os.path.splitext(img_path)[1]:
            img_path += ".png"
        img = _read_image(img_path)
        if img.shape[-1] not in (3, 4):
            raise ValueError(f"{img_path}: expected an RGB or RGBA image, got "
                             f"{img.shape[-1]} channels")
        if subsample > 1:
            img = img[::subsample, ::subsample]
        h, w = img.shape[:2]
        if img.shape[-1] == 4:
            alpha = img[..., 3:4]
            rgb = img[..., :3] * alpha + (1.0 - alpha)  # white bg composite
        else:
            alpha = np.ones((h, w, 1), np.float32)
            rgb = img[..., :3]
        focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
        intr = np.asarray([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)
        pose_gl = np.asarray(frame["transform_matrix"], np.float32)
        pose = opengl_to_opencv_pose(pose_gl)
        pose[:3, 3] *= pose_scale
        cams.append(Camera(intr, pose, w, h, camera_id=i))
        rgbs.append(rgb)
        masks.append(alpha)
    return Split(cams, np.stack(rgbs), np.stack(masks))


def _decompose_projection(P: np.ndarray):
    """K, R, t from a 3x4 projection P = K [R | t] (RQ via flipped QR)."""
    M = P[:3, :3]
    Q, U = np.linalg.qr(np.flipud(M).T)
    K = np.flipud(np.fliplr(U.T))
    R = np.flipud(Q.T)
    # make K's diagonal positive
    S = np.diag(np.sign(np.diag(K)))
    K = K @ S
    R = S @ R
    if np.linalg.det(R) < 0:
        R = -R
        K = -K
    t = np.linalg.solve(K, P[:3, 3])
    K = K / K[2, 2]
    return K.astype(np.float32), R.astype(np.float32), t.astype(np.float32)


def _load_dtu_cameras(scene_path: str, subsample: int) -> Split:
    """IDR-style DTU scene: image/*.png (+ optional mask/*.png) and
    cameras.npz with world_mat_i / scale_mat_i. scale_mat normalizes the
    object into the unit sphere, matching the bounding primitive the methods
    assume."""
    cams_npz = np.load(os.path.join(scene_path, "cameras.npz"))
    img_dir = next(
        d for d in ("image", "images", "rgb")
        if os.path.isdir(os.path.join(scene_path, d))
    )
    img_files = sorted(
        f for f in os.listdir(os.path.join(scene_path, img_dir))
        if f.lower().endswith((".png", ".jpg"))
    )
    mask_dir = next(
        (d for d in ("mask", "masks") if os.path.isdir(os.path.join(scene_path, d))),
        None,
    )
    mask_files = (
        sorted(
            f for f in os.listdir(os.path.join(scene_path, mask_dir))
            if f.lower().endswith((".png", ".jpg"))
        )
        if mask_dir
        else None
    )

    cams, rgbs, masks = [], [], []
    for i, fname in enumerate(img_files):
        world_mat = cams_npz[f"world_mat_{i}"]
        scale_mat = (
            cams_npz[f"scale_mat_{i}"]
            if f"scale_mat_{i}" in cams_npz.files
            else np.eye(4, dtype=np.float64)
        )
        P = (world_mat @ scale_mat)[:3, :4]
        K, R, t = _decompose_projection(P)
        pose = np.eye(4, dtype=np.float32)  # camera-to-world (OpenCV)
        pose[:3, :3] = R.T
        pose[:3, 3] = -R.T @ t

        img = _read_image(os.path.join(scene_path, img_dir, fname))
        if subsample > 1:
            img = img[::subsample, ::subsample]
            K = K.copy()
            K[:2] /= subsample
        h, w = img.shape[:2]
        rgbs.append(img[..., :3])
        if mask_files:
            m = _read_image(os.path.join(scene_path, mask_dir, mask_files[i]))
            if subsample > 1:
                m = m[::subsample, ::subsample]
            masks.append((m[..., 0] > 0.5).astype(np.float32)[..., None])
        else:
            masks.append(np.ones((h, w, 1), np.float32))
        cams.append(Camera(K, pose, w, h, camera_id=i))
    return Split(cams, np.stack(rgbs), np.stack(masks))
