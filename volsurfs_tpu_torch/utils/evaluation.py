"""Image metrics (PSNR / SSIM / perceptual) and split evaluation (numpy
copy of volsurfs_tpu/utils/evaluation.py).

PSNR and SSIM are implemented directly (SSIM: standard 11x11
Gaussian-window formulation). The perceptual column is ``lpips_rf``: an
LPIPS-shaped distance over a fixed-seed *random* multi-scale conv feature
stack (normalize -> conv/ReLU x2 -> channel-unit-normalize -> squared
diff, averaged over scales), with the JAX package's filters
(``np.random.default_rng(12345)``), so the two packages give the same
value on the same images. It is deterministic and ranks runs of this
codebase against each other, but is NOT calibrated against published
LPIPS numbers, hence the distinct column name.
"""

from __future__ import annotations

import csv
import functools
import os

import numpy as np

from volsurfs_tpu_torch.utils import png
from volsurfs_tpu_torch.utils.rendering import save_image_png


def psnr(gt: np.ndarray, pred: np.ndarray, max_val: float = 1.0) -> float:
    mse = float(np.mean((gt.astype(np.float64) - pred.astype(np.float64)) ** 2))
    if mse <= 1e-12:
        return 99.0
    return float(10.0 * np.log10(max_val**2 / mse))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - size // 2
    k = np.exp(-(ax**2) / (2 * sigma**2))
    k = k / k.sum()
    return np.outer(k, k)


def _windows(img: np.ndarray, kh: int, kw: int) -> np.ndarray:
    """Every valid kh x kw window of img [H, W, C] as a strided view
    [H - kh + 1, W - kw + 1, kh, kw, C]."""
    h, w = img.shape[:2]
    strides = img.strides[:2] + img.strides[:2] + img.strides[2:]
    shape = (h - kh + 1, w - kw + 1, kh, kw) + img.shape[2:]
    return np.lib.stride_tricks.as_strided(img, shape=shape, strides=strides)


def _filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """valid-mode 2D filter of each channel with kernel [kh, kw]."""
    return np.tensordot(_windows(img, *kernel.shape), kernel, axes=([2, 3], [0, 1]))


def ssim(gt: np.ndarray, pred: np.ndarray, max_val: float = 1.0) -> float:
    """Mean SSIM over an 11x11 Gaussian window (Wang et al. 2004)."""
    if gt.ndim == 2:
        gt, pred = gt[..., None], pred[..., None]
    gt = gt.astype(np.float64)
    pred = pred.astype(np.float64)
    k = _gaussian_kernel()
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_x = _filter2d(gt, k)
    mu_y = _filter2d(pred, k)
    sigma_x = _filter2d(gt * gt, k) - mu_x**2
    sigma_y = _filter2d(pred * pred, k) - mu_y**2
    sigma_xy = _filter2d(gt * pred, k) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
    return float(np.mean(num / den))


@functools.lru_cache(maxsize=1)
def _rf_filters():
    """Fixed-seed random conv stacks: per scale, two 3x3 conv layers
    (3->24->24 channels), filters unit-normalized."""
    rng = np.random.default_rng(12345)

    def make(c_in, c_out):
        f = rng.normal(size=(c_out, 3, 3, c_in))
        return (f / np.linalg.norm(f.reshape(c_out, -1), axis=1)
                .reshape(-1, 1, 1, 1)).astype(np.float64)

    return make(3, 24), make(24, 24)


def _conv_relu(img: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """valid-mode conv + ReLU; img [H, W, C], filters [K, kh, kw, C]: one
    matrix product of the windows [H' W', kh kw C] and the filters (the
    JAX package sums the same products with einsum, in another order)."""
    win = _windows(img, *filters.shape[1:3])
    oh, ow = win.shape[:2]
    out = win.reshape(oh * ow, -1) @ filters.reshape(filters.shape[0], -1).T
    return np.maximum(out.reshape(oh, ow, -1), 0.0)


def _downsample2(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    return img[: h // 2 * 2, : w // 2 * 2].reshape(
        h // 2, 2, w // 2, 2, -1
    ).mean((1, 3))


def lpips_rf(gt: np.ndarray, pred: np.ndarray) -> float:
    """Random-feature perceptual distance (see module docstring). Inputs
    [H, W, 3] in [0, 1]. Lower is more similar; identical images give 0.
    Its absolute values are NOT comparable to published VGG-LPIPS numbers."""
    f1, f2 = _rf_filters()
    dist = 0.0
    nr_scales = 0
    a = gt.astype(np.float64) * 2.0 - 1.0
    b = pred.astype(np.float64) * 2.0 - 1.0
    for _ in range(3):
        if min(a.shape[:2]) < 8:
            break
        fa = _conv_relu(_conv_relu(a, f1), f2)
        fb = _conv_relu(_conv_relu(b, f1), f2)
        # channel-unit-normalize per pixel (LPIPS's feature normalization)
        fa = fa / (np.linalg.norm(fa, axis=-1, keepdims=True) + 1e-10)
        fb = fb / (np.linalg.norm(fb, axis=-1, keepdims=True) + 1e-10)
        dist += float(np.mean(np.sum((fa - fb) ** 2, axis=-1)))
        nr_scales += 1
        a, b = _downsample2(a), _downsample2(b)
    return dist / max(nr_scales, 1)


def eval_rendered_imgs(renders_dir: str, gt_dir: str, split_name: str = "test"):
    """Evaluate pre-rendered PNG pairs from disk, matching gt/pred files by
    name. Returns a PerSceneEvaluator with per-image rows filled."""
    evaluator = PerSceneEvaluator(split_name)
    names = sorted(
        f for f in os.listdir(renders_dir) if f.lower().endswith(".png")
    )
    for name in names:
        gt_path = os.path.join(gt_dir, name)
        if not os.path.exists(gt_path):
            continue
        pred = png.read(os.path.join(renders_dir, name)).astype(np.float32) / 255.0
        gt = png.read(gt_path).astype(np.float32) / 255.0
        pred, gt = pred[..., :3], gt[..., :3]
        evaluator.update(os.path.splitext(name)[0], gt, pred)
    return evaluator


def render_and_eval(trainer, split_name: str, out_dir: str):
    """Render a full split through ``trainer.render_camera``, save the
    renders and the ground truth as PNGs, evaluate and write the csv.
    Returns the means."""
    split = trainer.mv_data[split_name]
    evaluator = PerSceneEvaluator(split_name)
    for i, cam in enumerate(split.cameras):
        out = trainer.render_camera(cam)
        pred = np.clip(out["rgb"], 0, 1)
        save_image_png(pred, os.path.join(out_dir, "rgb"), f"{cam.camera_id:03d}")
        save_image_png(
            split.rgbs[i], os.path.join(out_dir, "gt"), f"{cam.camera_id:03d}"
        )
        evaluator.update(cam.camera_id, split.rgbs[i], pred)
    evaluator.save_csv(out_dir)
    return evaluator.means()


class PerSceneEvaluator:
    """Accumulates per-image metrics and writes a csv
    (reference utils/evaluation.py:16-83 layout)."""

    def __init__(self, split_name: str):
        self.split_name = split_name
        self.rows = []

    def update(self, image_id, gt: np.ndarray, pred: np.ndarray):
        self.rows.append(
            {
                "id": image_id,
                "psnr": psnr(gt, pred),
                "ssim": ssim(gt, pred),
                "lpips_rf": lpips_rf(gt, pred),
            }
        )

    def means(self) -> dict:
        if not self.rows:
            return {
                "psnr": float("nan"),
                "ssim": float("nan"),
                "lpips_rf": float("nan"),
            }
        return {
            m: float(np.mean([r[m] for r in self.rows]))
            for m in ("psnr", "ssim", "lpips_rf")
        }

    def save_csv(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{self.split_name}.csv")
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=["id", "psnr", "ssim", "lpips_rf"])
            writer.writeheader()
            for row in self.rows:
                writer.writerow(row)
            means = self.means()
            writer.writerow({"id": "mean", **means})
        return path
