"""Volume-rendering reductions over dense masked ray samples (counterpart of
volsurfs_tpu/ops/volume_rendering.py).

Every function takes [R, S] (or [R, S, C]) tensors and the samples' mask.
JAX sums and multiplies its scans as a tree (``associative_scan``); here
they run in order (``cumsum``, ``cumprod``), which differs in the last
bits.

Two of them are kernels of K8 (``csrc/volrender.cu``) on a CUDA tensor and
their plain versions, the torch ops below, on a CPU tensor:

- ``neus_transmittance`` (K8b): NeuS' transmittance scan with its weights,
  a warp a row (warp scans), forward and backward
  (``torch.autograd.Function``);
- ``neus_importance`` (K8c): from the SDFs at the samples to the new
  depths of one round of importance sampling (alphas, scan, normalised
  weights, CDF, its average over the surfaces, inverse-CDF placement), a
  warp a ray with its row in shared memory, without gradient;
- ``nerf_importance`` (K8d): the same round from the density at the
  samples (the nerf method's, with ``nerf_weights``' alphas), K8c's kernel
  template with one field.

``nerf_weights`` runs its transmittance scan through K8b.
"""

from __future__ import annotations

import torch

from volsurfs_tpu_torch import _build
from volsurfs_tpu_torch.ops.samples import RaySamples, batched_searchsorted

# launch counts: the CUDA kernels' and the plain versions'
launches = {"neus_transmittance_fwd": 0, "neus_transmittance_bwd": 0,
            "neus_transmittance_reference": 0, "neus_importance": 0,
            "neus_importance_reference": 0, "nerf_importance": 0,
            "nerf_importance_reference": 0}


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
    cos annealing; 0 where invalid. sdf [R, S] (or [R, S, 1]) with
    gradients [R, S, 3], or K surfaces at once: sdf [K, R, S] with
    gradients [K, R, S, 3] -> [K, R, S]."""
    if sdf.ndim == gradients.ndim:
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


def neus_transmittance_reference(alpha, mask):
    """Plain version of ``neus_transmittance`` (torch ops under autograd)."""
    launches["neus_transmittance_reference"] += 1
    alpha = torch.where(mask, alpha, 0.0)
    transmittance, bg = cumprod_one_minus_alpha_to_transmittance((1.0 - alpha) + 1e-6, mask)
    return alpha * transmittance, transmittance, bg


def _transmittance_inputs(alpha, mask):
    N, S = alpha.shape
    alpha, mask = alpha.contiguous(), mask.contiguous()
    _build.check_tensor("alpha", alpha, torch.float32, (N, S), alpha.device)
    _build.check_tensor("mask", mask, torch.bool, (N, S), alpha.device)
    return alpha, mask


class _NeusTransmittance(torch.autograd.Function):
    """K8b: (weights, transmittance, bg_transmittance) of alpha [N, S]; the
    backward gives alpha's gradient by the reverse recurrence (a suffix
    scan of affine maps), without a division."""

    @staticmethod
    def forward(ctx, alpha, mask):
        alpha, mask = _transmittance_inputs(alpha, mask)
        N, S = alpha.shape
        w = torch.empty_like(alpha)
        T = torch.empty_like(alpha)
        bg = torch.empty(N, 1, dtype=alpha.dtype, device=alpha.device)
        status = _build.kernels().vs_neus_transmittance_forward(
            alpha.data_ptr(), mask.data_ptr(), w.data_ptr(), T.data_ptr(), bg.data_ptr(), S, N,
            torch.cuda.current_stream(alpha.device).cuda_stream)
        _build.check(status, "neus_transmittance forward")
        launches["neus_transmittance_fwd"] += 1
        ctx.save_for_backward(alpha, mask, T)
        return w, T, bg

    @staticmethod
    def backward(ctx, g_w, g_T, g_bg):
        alpha, mask, T = ctx.saved_tensors
        N, S = alpha.shape
        grads = [g.contiguous() for g in (g_w, g_T, g_bg)]
        for name, g, shape in zip(("g_w", "g_T", "g_bg"), grads, ((N, S), (N, S), (N, 1))):
            _build.check_tensor(name, g, torch.float32, shape, alpha.device)
        g_alpha = torch.empty_like(alpha)
        status = _build.kernels().vs_neus_transmittance_backward(
            alpha.data_ptr(), mask.data_ptr(), T.data_ptr(), grads[0].data_ptr(),
            grads[1].data_ptr(), grads[2].data_ptr(), g_alpha.data_ptr(), S, N,
            torch.cuda.current_stream(alpha.device).cuda_stream)
        _build.check(status, "neus_transmittance backward")
        launches["neus_transmittance_bwd"] += 1
        return g_alpha, None


def neus_transmittance(alpha, mask):
    """(weights alpha T [N, S], transmittance T [N, S], bg_transmittance
    [N, 1]) of alpha [N, S] over the valid samples (alpha counts as 0 where
    mask is False): T is the exclusive product of (1 - alpha) + 1e-6, and
    bg_transmittance T at the last valid sample (1 for a row without
    samples), as JAX's ``cumprod_one_minus_alpha_to_transmittance`` with
    NeuS' bias. Differentiable in alpha."""
    if not alpha.is_cuda:
        return neus_transmittance_reference(alpha, mask)
    return _NeusTransmittance.apply(alpha, mask)


def neus_weights(samples: RaySamples, alpha):
    """(weights [R, S], transmittance [R, S], bg_transmittance [R, 1]) from
    the alphas, with NeuS' 1e-6 bias in the transmittance."""
    return neus_transmittance(alpha, samples.mask)


def _weights_cdf(samples: RaySamples, alpha):
    """The CDF of the weights of alpha [R, S] (the transmittance scan with
    its 1e-6 bias), normalised by their sum (at least 1e-6)."""
    w, _, _ = neus_transmittance_reference(alpha, samples.mask)
    _, w_sum = sum_over_rays(w, samples.mask)
    return compute_cdf(w / torch.clamp(w_sum, min=1e-6), samples.mask)


def neus_cdf(samples: RaySamples, sdfs, logistic_beta):
    """The CDF [R, S] of the normalised NeuS weights of each surface's SDF
    (sdfs [R, S, K], or [R, S] for one), averaged over the K surfaces."""
    if sdfs.ndim == 2:
        sdfs = sdfs[..., None]
    K = sdfs.shape[-1]
    cdfs = [_weights_cdf(samples, sdf2alpha(samples, sdfs[..., k], logistic_beta))
            for k in range(K)]
    return cdfs[0] if K == 1 else torch.sum(torch.stack(cdfs, dim=0), dim=0) / K


def neus_importance_reference(samples: RaySamples, sdfs, logistic_beta,
                              nr_importance_samples: int, jitter=None) -> RaySamples:
    """Plain version of ``neus_importance``."""
    launches["neus_importance_reference"] += 1
    return importance_sample(samples, neus_cdf(samples, sdfs, logistic_beta),
                             nr_importance_samples, jitter)


def neus_importance(samples: RaySamples, sdfs, logistic_beta, nr_importance_samples: int,
                    jitter=None) -> RaySamples:
    """One round of NeuS importance sampling: for each of K surfaces (sdfs
    [R, S, K], or [R, S] for one) the ``sdf2alpha`` alphas, their NeuS
    weights, normalised by their sum (at least 1e-6), and their CDF
    (``compute_cdf``); the CDFs averaged over K (as JAX's ``_avg_cdf``),
    then n new depths by ``importance_sample`` (jitter [R, n] or None).
    No gradient."""
    if not samples.z.is_cuda:
        return neus_importance_reference(samples, sdfs, logistic_beta, nr_importance_samples,
                                         jitter)
    fields = sdfs[..., None] if sdfs.ndim == 2 else sdfs
    return _importance_kernel("neus_importance", samples, fields, logistic_beta,
                              nr_importance_samples, jitter)


def _importance_kernel(name, samples: RaySamples, fields, beta, n: int, jitter) -> RaySamples:
    """K8c (name "neus_importance": the SDFs fields [R, S, K] at beta) or
    K8d ("nerf_importance": the density [R, S, 1]) on the card, one launch:
    n new depths a ray (jitter [R, n] or None). No gradient."""
    dev = samples.z.device
    R, S = samples.z.shape
    fields = fields.detach().contiguous()
    K = fields.shape[-1]
    z, dt, mask = (t.contiguous() for t in (samples.z, samples.dt, samples.mask))
    checks = [("z", z, torch.float32, (R, S)), ("dt", dt, torch.float32, (R, S)),
              ("mask", mask, torch.bool, (R, S)), ("fields", fields, torch.float32, (R, S, K))]
    if jitter is not None:
        jitter = jitter.contiguous()
        checks.append(("jitter", jitter, torch.float32, (R, n)))
    for arg, t, dtype, shape in checks:
        _build.check_tensor(arg, t, dtype, shape, dev)
    if not 2 <= S <= 4096:
        raise ValueError(f"{name}: 2 to 4096 samples a ray (got {S})")
    z_imp = torch.empty(R, n, dtype=torch.float32, device=dev)
    mask_imp = torch.empty(R, n, dtype=torch.bool, device=dev)
    status = _build.kernels().vs_importance(
        z.data_ptr(), dt.data_ptr(), mask.data_ptr(), fields.data_ptr(),
        None if jitter is None else jitter.data_ptr(), float(beta), z_imp.data_ptr(),
        mask_imp.data_ptr(), S, K, n, R, int(name == "nerf_importance"),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, name)
    launches[name] += 1
    return RaySamples(z=z_imp, dt=torch.zeros_like(z_imp), mask=mask_imp, rays_o=samples.rays_o,
                      rays_d=samples.rays_d, t_near=samples.t_near, t_far=samples.t_far,
                      max_dt=samples.max_dt)


def nerf_alpha(samples: RaySamples, densities):
    """clip(1 - exp(-sigma dt), 0, 1) of each valid sample, 0 elsewhere
    (densities [R, S] or [R, S, 1])."""
    if densities.ndim == 3:
        densities = densities[..., 0]
    # maximum and minimum, not clamp: at a tie (a density of 0) their
    # gradient is half, as jnp.clip's
    bounds = torch.zeros((), device=densities.device), torch.ones((), device=densities.device)
    alpha = torch.minimum(torch.maximum(1.0 - torch.exp(-densities * samples.dt), bounds[0]),
                          bounds[1])
    return torch.where(samples.mask, alpha, 0.0)


def nerf_weights(samples: RaySamples, densities):
    """(weights alpha T [R, S], bg_transmittance [R, 1]) of the densities
    at the samples: ``nerf_alpha``, then the transmittance scan with the
    1e-6 bias, which is NeuS' (K8b on the card). Differentiable in the
    densities."""
    weights, _, bg = neus_transmittance(nerf_alpha(samples, densities), samples.mask)
    return weights, bg


def nerf_cdf(samples: RaySamples, densities):
    """The CDF [R, S] of the density's NeRF weights, normalised by their sum
    (at least 1e-6)."""
    return _weights_cdf(samples, nerf_alpha(samples, densities))


def nerf_importance_reference(samples: RaySamples, densities, nr_importance_samples: int,
                              jitter=None) -> RaySamples:
    """Plain version of ``nerf_importance``."""
    launches["nerf_importance_reference"] += 1
    return importance_sample(samples, nerf_cdf(samples, densities), nr_importance_samples,
                             jitter)


def nerf_importance(samples: RaySamples, densities, nr_importance_samples: int,
                    jitter=None) -> RaySamples:
    """The nerf method's round of importance sampling: the NeRF weights of
    the densities [R, S] (or [R, S, 1]) at the samples, normalised by their
    sum (at least 1e-6), their CDF (``compute_cdf``), then n new depths by
    ``importance_sample`` (jitter [R, n] or None). No gradient."""
    if not samples.z.is_cuda:
        return nerf_importance_reference(samples, densities, nr_importance_samples, jitter)
    fields = densities if densities.ndim == 3 else densities[..., None]
    return _importance_kernel("nerf_importance", samples, fields, 0.0, nr_importance_samples,
                              jitter)
