"""Volume-rendering reductions over dense masked ray samples (counterpart of
volsurfs_tpu/ops/volume_rendering.py; K8 in ROADMAP.md, torch ops with
autograd for now).

Every function takes [R, S] (or [R, S, C]) tensors and the samples' mask.
JAX sums and multiplies its scans as a tree (``associative_scan``); here
they run in order (``cumsum``, ``cumprod``), which differs in the last
bits.
"""

from __future__ import annotations

import torch

from volsurfs_tpu_torch.ops.samples import RaySamples, batched_searchsorted


def _gather(x, idx):
    return torch.gather(x, 1, idx.long())


def cumprod_one_minus_alpha_to_transmittance(one_minus_alpha, mask):
    """Exclusive cumulative product of (1 - alpha) over the valid samples:
    (transmittance [R, S], bg_transmittance [R, 1], the transmittance at
    the last valid sample, 1 for a ray without samples)."""
    oma = torch.where(mask, one_minus_alpha, 1.0)
    inclusive = torch.cumprod(oma, dim=1)
    transmittance = torch.cat([torch.ones_like(inclusive[:, :1]), inclusive[:, :-1]], dim=1)
    count = torch.sum(mask, dim=1)
    last_idx = torch.clamp(count - 1, min=0)
    bg = _gather(transmittance, last_idx[:, None])
    bg = torch.where(count[:, None] > 0, bg, 1.0)
    return transmittance, bg


def integrate(values, weights, mask):
    """sum_s w[r, s] * values[r, s, :] -> [R, C] (weights [R, S] or [R, S, 1])."""
    if weights.ndim == values.ndim:
        weights = weights[..., 0]
    w = torch.where(mask, weights, 0.0)
    return torch.einsum("rs,rsc->rc", w, values)


def sum_over_rays(values, mask):
    """(per-ray sum [R, 1], that sum broadcast to every sample [R, S])."""
    if values.ndim == 3:
        values = values[..., 0]
    v = torch.where(mask, values, 0.0)
    per_ray = torch.sum(v, dim=1, keepdim=True)
    return per_ray, per_ray.expand(values.shape)


def compute_cdf(weights, mask):
    """Exclusive cumsum of the weights; a total within 1e-3 of 1 snaps the
    last valid entry to 1; invalid slots hold 2."""
    w = torch.where(mask, weights if weights.ndim == 2 else weights[..., 0], 0.0)
    inclusive = torch.cumsum(w, dim=1)
    cdf = torch.cat([torch.zeros_like(inclusive[:, :1]), inclusive[:, :-1]], dim=1)
    total = torch.sum(w, dim=1, keepdim=True)
    count = torch.sum(mask, dim=1, keepdim=True)
    last_idx = torch.clamp(count - 1, min=0)
    snap = torch.abs(total - 1.0) < 1e-3
    is_last = torch.arange(cdf.shape[1], device=cdf.device)[None, :] == last_idx
    cdf = torch.where(snap & is_last & mask, 1.0, cdf)
    return torch.where(mask, cdf, 2.0)


def _map_range(x, in_start, in_end, out_start, out_end):
    """map_range_val: x clamped to the range; a degenerate range gives
    out_end."""
    x = torch.minimum(torch.maximum(x, torch.minimum(in_start, in_end)),
                      torch.maximum(in_start, in_end))
    denom = in_end - in_start
    t = torch.where(denom != 0.0, (x - in_start) / torch.where(denom == 0.0, 1.0, denom), 1.0)
    return out_start + (out_end - out_start) * t


def importance_sample(samples: RaySamples, cdf, nr_importance_samples: int,
                      jitter=None) -> RaySamples:
    """Inverse-CDF sampling of n new depths a ray: targets (i+1)/(n+1),
    moved by jitter [R, n] (uniform in [-0.5, 0.5), or None) times
    1/(n+1), clamped to (1e-6, 1-1e-6), each placed by linear interpolation
    between the samples that bracket it. Rays with fewer than 2 samples get
    none."""
    R = cdf.shape[0]
    n = nr_importance_samples
    spacing = 1.0 / (n + 1)
    u = spacing * (1.0 + torch.arange(n, dtype=torch.float32, device=cdf.device))[None, :]
    u = u.expand(R, n)
    if jitter is not None:
        u = u + jitter * spacing
    u = torch.clamp(u, 1e-6, 1.0 - 1e-6)

    count = torch.sum(samples.mask, dim=1, keepdim=True).to(torch.int32)
    imax = batched_searchsorted(cdf, u, side="right")
    imax = torch.minimum(imax, torch.clamp(count - 1, min=0))
    imax = torch.clamp(imax, min=1)
    imin = imax - 1
    z_imp = _map_range(u, _gather(cdf, imin), _gather(cdf, imax),
                       _gather(samples.z, imin), _gather(samples.z, imax))
    mask = (count >= 2).expand(R, n)
    z_imp = torch.where(mask, z_imp, 1e10)
    return RaySamples(z=z_imp, dt=torch.zeros_like(z_imp), mask=mask, rays_o=samples.rays_o,
                      rays_d=samples.rays_d, t_near=samples.t_near, t_far=samples.t_far,
                      max_dt=samples.max_dt)


def median_depth(samples: RaySamples, weights, threshold: float = 0.5):
    """Depth where the cumulative weight first reaches threshold (the last
    valid depth if never): [R, 1]."""
    w = torch.where(samples.mask, weights if weights.ndim == 2 else weights[..., 0], 0.0)
    reached = (torch.cumsum(w, dim=1) >= threshold) & samples.mask
    first_idx = torch.argmax(reached.to(torch.uint8), dim=1)
    count = torch.sum(samples.mask, dim=1)
    idx = torch.where(torch.any(reached, dim=1), first_idx, torch.clamp(count - 1, min=0))
    return _gather(samples.z, idx[:, None])


def sdf2alpha(samples: RaySamples, sdf, logistic_beta):
    """NeuS alpha from consecutive sample pairs (importance sampling): the
    last valid sample of a ray gets 0."""
    if sdf.ndim == 3:
        sdf = sdf[..., 0]
    dt = samples.dt
    next_sdf = torch.cat([sdf[:, 1:], sdf[:, -1:]], dim=1)
    next_valid = torch.cat([samples.mask[:, 1:], torch.zeros_like(samples.mask[:, :1])], dim=1)
    pair_valid = samples.mask & next_valid
    mid_sdf = 0.5 * (sdf + next_sdf)
    cos_val = torch.clamp((next_sdf - sdf) / (dt + 1e-6), -1e3, 0.0)
    prev_esti = mid_sdf - cos_val * dt * 0.5
    next_esti = mid_sdf + cos_val * dt * 0.5
    prev_cdf = torch.sigmoid(prev_esti * logistic_beta)
    next_cdf = torch.sigmoid(next_esti * logistic_beta)
    alpha = (prev_cdf - next_cdf + 1e-6) / (prev_cdf + 1e-6)
    return torch.where(pair_valid, alpha, 0.0)


def neus_alpha_from_sdf_gradients(samples: RaySamples, sdf, gradients, cos_anneal_ratio,
                                  logistic_beta):
    """NeuS alpha from the SDF and its gradients at the samples, with the
    cos annealing; 0 where invalid."""
    if sdf.ndim == 3:
        sdf = sdf[..., 0]
    dists = samples.dt
    true_cos = torch.sum(samples.dirs() * gradients, dim=-1)
    iter_cos = (torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                + torch.relu(-true_cos) * cos_anneal_ratio)
    iter_cos = -iter_cos
    estimated_next_sdf = sdf + iter_cos * dists * 0.5
    estimated_prev_sdf = sdf - iter_cos * dists * 0.5
    prev_cdf = torch.sigmoid(estimated_prev_sdf * logistic_beta)
    next_cdf = torch.sigmoid(estimated_next_sdf * logistic_beta)
    alpha = torch.clamp((prev_cdf - next_cdf + 1e-6) / (prev_cdf + 1e-6), 0.0, 1.0)
    return torch.where(samples.mask, alpha, 0.0)


def neus_weights(samples: RaySamples, alpha):
    """(weights [R, S], transmittance [R, S], bg_transmittance [R, 1]) from
    the alphas, with NeuS' 1e-6 bias in the transmittance."""
    alpha = torch.where(samples.mask, alpha, 0.0)
    transmittance, bg = cumprod_one_minus_alpha_to_transmittance((1.0 - alpha) + 1e-6,
                                                                 samples.mask)
    return alpha * transmittance, transmittance, bg
