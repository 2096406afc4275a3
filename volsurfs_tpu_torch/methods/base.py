"""Method utilities: gradient norms, optimizer and chunked frame rendering
(counterpart of volsurfs_tpu/methods/base.py)."""

from __future__ import annotations

from typing import Callable

import torch

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
