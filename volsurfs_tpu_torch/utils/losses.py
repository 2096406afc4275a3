"""Loss functions (counterpart of volsurfs_tpu/utils/losses.py)."""

from __future__ import annotations

import torch

from volsurfs_tpu_torch.utils.math import safe_norm


def loss_l1(gt, pred, mask=None):
    if mask is not None:
        return torch.mean(torch.abs(gt - pred) * mask)
    return torch.mean(torch.abs(gt - pred))


def sparsity_loss(densities, lambda_sparsity: float = 1.0):
    loss = torch.mean(1.0 - torch.exp(-lambda_sparsity * densities))
    return torch.clamp(loss, min=0.0)


def eikonal_loss(sdf_gradients, distance_scale: float = 1.0):
    return torch.mean((safe_norm(sdf_gradients, dim=-1) - distance_scale) ** 2)


def offsurface_loss(sdf):
    """exp penalty on near-zero sdf at random points."""
    return torch.mean(torch.exp(-1e2 * torch.abs(sdf)))
