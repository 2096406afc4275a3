"""Image metrics (a copy of volsurfs_tpu/utils/evaluation.py's ``psnr``)."""

from __future__ import annotations

import numpy as np


def psnr(gt: np.ndarray, pred: np.ndarray, max_val: float = 1.0) -> float:
    mse = float(np.mean((gt.astype(np.float64) - pred.astype(np.float64)) ** 2))
    if mse <= 1e-12:
        return 99.0
    return float(10.0 * np.log10(max_val**2 / mse))
