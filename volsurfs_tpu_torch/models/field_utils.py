"""Field gradients by finite differences, and the SDF curvature proxy
(counterpart of volsurfs_tpu/models/field_utils.py)."""

from __future__ import annotations

import torch

from volsurfs_tpu_torch.utils.math import safe_normalize


def get_field_gradients(field_fn, points, eps: float = 1e-4):
    """Forward differences of a scalar field: field_fn maps [..., 3] to
    [..., 1] (or a tuple led by it); returns [..., 3]. The 4 evaluations run
    one after the other, as JAX's lax.map does."""
    offsets = torch.tensor([[0.0, 0.0, 0.0], [eps, 0.0, 0.0], [0.0, eps, 0.0], [0.0, 0.0, eps]],
                           dtype=points.dtype, device=points.device)
    sdf = []
    for off in offsets:
        res = field_fn(points + off)
        val = res[0] if isinstance(res, tuple) else res
        sdf.append(val[..., 0:1])
    sdf = torch.stack(sdf, dim=0)  # [4, ..., 1]
    grad = (sdf[1:] - sdf[0:1]) / eps
    return torch.movedim(grad, 0, -1)[..., 0, :]


def get_fields_gradients(fields_fn, points, eps: float = 1e-4):
    """Forward differences of a K-output field: fields_fn maps [..., 3] to
    [..., K] (or a tuple led by it); returns [..., K, 3]."""
    offsets = torch.tensor([[0.0, 0.0, 0.0], [eps, 0.0, 0.0], [0.0, eps, 0.0], [0.0, 0.0, eps]],
                           dtype=points.dtype, device=points.device)
    vals = []
    for off in offsets:
        res = fields_fn(points + off)
        vals.append(res[0] if isinstance(res, tuple) else res)
    vals = torch.stack(vals, dim=0)  # [4, ..., K]
    return torch.movedim((vals[1:] - vals[0:1]) / eps, 0, -1)


def get_sdf_curvature(field_fn, points, sdf_gradients, rand_dirs, eps: float = 1e-4,
                      grad_fn=None):
    """Angle / pi between the normal at each point and at the point moved
    eps along a random tangent (rand_dirs [..., 3], normal draws): [..., 1].
    grad_fn(points) gives the moved points' gradients (finite differences
    of field_fn by default)."""
    normals = safe_normalize(sdf_gradients)
    tangents = torch.linalg.cross(normals, safe_normalize(rand_dirs), dim=-1)
    shifted = points + tangents * eps
    if grad_fn is not None:
        grads_shifted = grad_fn(shifted)
    else:
        grads_shifted = get_field_gradients(field_fn, shifted, eps)
    dot = torch.sum(normals * safe_normalize(grads_shifted), dim=-1, keepdim=True)
    return torch.arccos(torch.clamp(dot, -1.0 + 1e-6, 1.0 - 1e-6)) / torch.pi
