"""Small numeric helpers (counterpart of volsurfs_tpu/utils/math.py)."""

from __future__ import annotations

import torch


def safe_norm(x, dim: int = -1, keepdim: bool = False, eps: float = 1e-12):
    """L2 norm with a well-defined gradient at 0."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)


def safe_normalize(x, dim: int = -1, eps: float = 1e-12):
    return x / safe_norm(x, dim=dim, keepdim=True, eps=eps)


def fma32(a, b, c):
    """fma(a, b, c) of float32 tensors, through float64: the product of two
    float32 values is exact there, and rounding the float64 sum to float32
    equals the fma's single rounding but for rare double-rounding ties."""
    return (a.double() * b.double() + c.double()).float()


def norm3(x):
    """|x| over the last axis of [..., 3] -> [...], rounded as XLA:CPU's
    jnp.linalg.norm: sqrt(fma(x2, x2, fma(x1, x1, x0 * x0))). The square
    root is taken in float64 and rounded once: torch's float32 square root
    on the CPU is not always the nearest float (1 ulp off on some inputs)."""
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    return torch.sqrt(fma32(x2, x2, fma32(x1, x1, x0 * x0)).double()).float()


MASK32 = 0xFFFFFFFF


def mul_u32(a, prime: int):
    """(a * prime) mod 2^32 for int64 a in [0, 2^32), without int64 overflow."""
    lo, hi = prime & 0xFFFF, prime >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def take_rev(x, dim: int):
    """Reverse along a (tiny) axis."""
    return torch.flip(x, dims=(dim,))


def small_cumsum(x, dim: int):
    """Cumulative sum along a tiny axis, as a chain of additions; an empty
    axis gives the empty tensor (offsets_surfs without outer surfaces, as
    config/offsets_surfs/base_5.cfg; JAX's small_cumsum raises there)."""
    if x.shape[dim] == 0:
        return x
    slices = torch.unbind(x, dim=dim)
    acc = slices[0]
    outs = [acc]
    for s in slices[1:]:
        acc = acc + s
        outs.append(acc)
    return torch.stack(outs, dim=dim)


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
