"""Loss functions (counterpart of volsurfs_tpu/utils/losses.py)."""

from __future__ import annotations

import torch


def loss_l1(gt, pred, mask=None):
    if mask is not None:
        return torch.mean(torch.abs(gt - pred) * mask)
    return torch.mean(torch.abs(gt - pred))
