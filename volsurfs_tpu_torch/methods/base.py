"""Method utilities: gradient norms, optimizer, chunked frame rendering
(counterpart of volsurfs_tpu/methods/base.py) and the background every
method shares: a constant colour, or the trained ``NerfHash`` field over
the contracted space, rendered by ``render_contracted_bg`` (JAX's
methods/surf.py:39-62).

The background's samples are kernel K10 on the card (``ops/samplers.py::
contracted_bg_samples``), its transmittance scan K8b
(``ops/volume_rendering.py::neus_transmittance``), its field's lookup K6.
"""

from __future__ import annotations

from typing import Callable

import torch

from volsurfs_tpu_torch.models.fields import NerfHash
from volsurfs_tpu_torch.ops import samplers as SP
from volsurfs_tpu_torch.ops import volume_rendering as VR
from volsurfs_tpu_torch.utils.schedules import make_lr_schedule


def grad_norms(models) -> dict:
    """{"grad_norm/<name>": L2 norm of the module's gradients} of a
    ModuleDict, as 0-d tensors (modules without gradients give 0)."""
    out = {}
    for name, module in models.items():
        norms = [torch.linalg.vector_norm(p.grad.float()) for p in module.parameters()
                 if p.grad is not None]
        out[f"grad_norm/{name}"] = (torch.linalg.vector_norm(torch.stack(norms)) if norms
                                    else torch.zeros(()))
    return out


def make_optimizer(hp, params, warmup_start_iter: int = 0):
    """Adam(betas=(0.9, 0.99), eps=1e-15) with the warmup + MultiStep(0.3)
    learning-rate schedule. Returns (optimizer, scheduler); step the
    scheduler after each ``optimizer.step()``.

    The first update uses the schedule at step 0, as optax does (under
    warmup its learning rate is 0)."""
    schedule = make_lr_schedule(
        hp.lr,
        hp.lr_milestones,
        gamma=0.3,
        warmup_start_iter=warmup_start_iter,
        warmup_iters=hp.nr_warmup_iters,
    )
    optimizer = torch.optim.Adam(params, lr=hp.lr, betas=(0.9, 0.99), eps=1e-15)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: schedule(step) / hp.lr
    )
    return optimizer, scheduler


def render_frame_chunked(render_rays_fn: Callable, rays_o, rays_d, chunk_size: int) -> dict:
    """Render rays [N, 3] in chunks of chunk_size and concatenate the
    outputs (dicts of [n, ...] tensors)."""
    outs = [
        render_rays_fn(rays_o[i : i + chunk_size], rays_d[i : i + chunk_size])
        for i in range(0, rays_o.shape[0], chunk_size)
    ]
    return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}


def make_background(bg_color, hp, device, generator: torch.Generator | None = None):
    """(constant colour [1, 3] on device or None, NerfHash or None): the
    trained background for bg_color None or "trained" (its encoder from
    hp.bg_pos_encoder_type over the contracted space, bb_sides None), a
    constant white or black otherwise."""
    if bg_color in (None, "trained"):
        return None, NerfHash(pos_encoder_type=hp.bg_pos_encoder_type,
                              nr_iters_for_c2f=hp.bg_nr_iters_for_c2f, bb_sides=None,
                              mlp_dtype="bfloat16" if hp.use_grad_scaler else None,
                              generator=generator)
    if bg_color == "white":
        return torch.ones(1, 3, device=device), None
    if bg_color == "black":
        return torch.zeros(1, 3, device=device), None
    raise ValueError(f"bad bg_color {bg_color}")


def render_contracted_bg(bg_model, raycast: dict, nr_samples_bg: int, jitter=None,
                         iter_nr=None) -> dict:
    """The background of the rays of raycast (their far ends on the
    bounding primitive onward) through the field bg_model over the
    contracted space: nr_samples_bg samples a ray (jitter [R, N] or None),
    alphas 1 - exp(-sigma dt) unclipped, NeuS' transmittance scan with its
    1e-6 bias; {"pred_rgb" [R, 3], "median_depth" [R, 1] (uncontracted)}.
    Differentiable in bg_model's parameters."""
    cpos, dirs, c_samples, z = SP.contracted_bg_samples(
        raycast["rays_o"], raycast["rays_d"], raycast["t_far"], nr_samples_bg, jitter)
    rgb_samples, density = bg_model(cpos, dirs, iter_nr)
    alpha = 1.0 - torch.exp(-density[..., 0] * c_samples.dt)
    alpha = torch.where(c_samples.mask, alpha, 0.0)
    weights, _, _ = VR.neus_transmittance(alpha, c_samples.mask)
    return {"pred_rgb": VR.integrate(rgb_samples, weights, c_samples.mask),
            "median_depth": VR.median_depth(c_samples.replace(z=z), weights.detach())}


def render_background(method, raycast: dict, nr_rays: int, iter_nr, train: bool):
    """(rgb_bg [R, 3], depth_bg [R, 1]) of a method: its constant colour and
    the rays' far ends, or its trained background (its samples jittered by
    a draw of method._uniform in training)."""
    if "bg" not in method.models:
        return method.bg_color.expand(nr_rays, 3), raycast["t_far"]
    N = method.hp.nr_samples_bg
    jitter = method._uniform((nr_rays, N)) if train else None
    res = render_contracted_bg(method.models["bg"], raycast, N, jitter, iter_nr)
    return res["pred_rgb"], res["median_depth"]
