"""Small numeric helpers (counterpart of volsurfs_tpu/utils/math.py)."""

from __future__ import annotations

import torch


def safe_norm(x, dim: int = -1, keepdim: bool = False, eps: float = 1e-12):
    """L2 norm with a well-defined gradient at 0."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)


def take_rev(x, dim: int):
    """Reverse along a (tiny) axis."""
    return torch.flip(x, dims=(dim,))


def small_cumprod(x, dim: int):
    """Cumulative product along a tiny axis, as a chain of products in the
    input's dtype (float16 on the compositing path), so that each partial
    product rounds as the JAX unrolled chain does."""
    slices = torch.unbind(x, dim=dim)
    acc = slices[0]
    outs = [acc]
    for s in slices[1:]:
        acc = acc * s
        outs.append(acc)
    return torch.stack(outs, dim=dim)
