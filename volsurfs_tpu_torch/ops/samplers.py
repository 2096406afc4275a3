"""Ray samples: uniform, inside the occupied space of an occupancy grid,
and the background's behind the bounding primitive (counterpart of
volsurfs_tpu/ops/samplers.py).

The occupied-space sampler is kernel K7 (``csrc/occupancy_sampler.cu``:
each pass's grid reads in flight together; on grids whose extents are
powers of two four warps a ray below 2,048 rays and a warp a ray from
there on, on other grids four warps a ray) on a CUDA tensor and the plain
version ``occupancy_samples_reference`` on a CPU tensor. Both clip the ray
to its first and last occupied probe of ``nr_probe_steps`` (optional),
march ``nr_march_steps`` steps, measure the occupied arc length and place
up to S samples evenly along it from a jittered start.

The occupied arc after step k is (occupied steps up to k) * step length,
one product of an exact count; JAX sums the step lengths as a tree
(``associative_scan``), so its arc differs from this one in the last bits
and a target within an ulp of a step's end can move a sample by a step or
flip its mask. The kernel counts with warp ballots and places the targets
by a binary search of the same products, so it equals the plain version bit
for bit.

``importance_refine`` adds the NeuS samplers' two rounds of importance
sampling to the occupied-space samples (K8c and K8a on the card).

The background's samples (``compute_samples_bg``, inverse-depth spacing
from the bounding primitive's far end to 100) are contracted into the unit
ball (``contract_samples``, mip-NeRF 360's contraction at scale 2), where
the background field lives. ``contracted_bg_samples`` does both in one
launch of kernel K10 (``csrc/bg_samples.cu``: a thread a sample, each
depth and contraction computed once, neighbours' values by shuffles) on a
CUDA tensor and in the plain version ``bg_samples_reference`` (the
functions above) on a CPU tensor; the two agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from volsurfs_tpu_torch import _build
from volsurfs_tpu_torch.ops import samples as TS
from volsurfs_tpu_torch.ops import volume_rendering as VR
from volsurfs_tpu_torch.ops.samples import INVALID_Z, RaySamples, update_dt
from volsurfs_tpu_torch.utils.math import norm3

# launch counts: the CUDA kernel's and the plain version's
launches = {"occupancy_sampler": 0, "occupancy_sampler_reference": 0,
            "bg_samples": 0, "bg_samples_reference": 0}
# the most samples a ray K10 takes: a row's samples are the threads of one
# block (csrc/bg_samples.cu, kMaxSamples)
BG_MAX_SAMPLES = 1024


def _plan_sample_counts(dist, min_dist_between_samples, max_nr_samples, min_nr_samples):
    """(nr [R, 1] int32, const_dist [R, 1]): clamp(dist / min_dist, 0, max)
    samples spaced dist / nr; a distance up to min_dist takes 1 sample, none
    takes 0, and rays below min_nr samples take 0."""
    # a tensor divisor, as in _steps
    min_dist = torch.tensor(min_dist_between_samples, dtype=dist.dtype, device=dist.device)
    nr_big = torch.clamp((dist / min_dist).to(torch.int32), 0, max_nr_samples)
    nr = torch.where(dist <= 0.0, 0, torch.where(dist > min_dist, nr_big, 1))
    const_dist = torch.where(nr > 0, dist / torch.clamp(nr, min=1).to(dist.dtype), 0.0)
    nr = torch.where(nr >= min_nr_samples, nr, 0)
    return nr.to(torch.int32), const_dist


def compute_samples_fg(rays_o, rays_d, t_near, t_far, min_dist_between_samples: float,
                       min_nr_samples_per_ray: int, max_nr_samples_per_ray: int,
                       jitter=None) -> RaySamples:
    """Equispaced samples in [t_near, t_far] from a jittered start (jitter
    [R, 1] in [0, 1), or None)."""
    R, S = rays_o.shape[0], max_nr_samples_per_ray
    nr, const_dist = _plan_sample_counts(t_far - t_near, min_dist_between_samples, S,
                                         min_nr_samples_per_ray)
    if jitter is None:
        jitter = torch.zeros(R, 1, device=rays_o.device)
    i = torch.arange(S, dtype=torch.float32, device=rays_o.device)[None, :]
    z = t_near + (jitter + i) * const_dist
    mask = (i < nr.float()) & (z < t_far) & (nr > 0)
    z = torch.where(mask, torch.clamp(z, t_near, t_far), INVALID_Z)
    out = RaySamples(z=z, dt=torch.zeros_like(z), mask=mask, rays_o=rays_o, rays_d=rays_d,
                     t_near=t_near, t_far=t_far, max_dt=const_dist)
    return update_dt(out, is_background=False)


def _steps(n: int, like):
    """n as a divisor tensor: a CUDA division by a Python number multiplies
    by its reciprocal instead, which rounds otherwise than the kernel's
    division (alike only for powers of 2)."""
    return torch.tensor(float(n), dtype=like.dtype, device=like.device)


def _probe(rays_o, rays_d, t_near, seg, nr_steps, grid):
    """Occupancy at the midpoints of nr_steps steps of length seg [R, 1]
    from t_near: [R, nr_steps] bool (all False where seg is 0)."""
    R = rays_o.shape[0]
    k = torch.arange(nr_steps, dtype=torch.float32, device=rays_o.device)[None, :]
    t_mid = t_near + (k + 0.5) * seg
    pts = rays_o[:, None, :] + t_mid[..., None] * rays_d[:, None, :]
    occ = grid.check_occupancy(pts.reshape(-1, 3)).reshape(R, nr_steps)
    return occ & (seg > 0.0)


def rays_t_near_t_far_in_occupancy(rays_o, rays_d, t_near, t_far, grid,
                                   nr_probe_steps: int = 512):
    """Each ray's [t_near, t_far] tightened to its first and last occupied
    probe (midpoints of nr_probe_steps equal steps); a ray with none
    collapses to [t_near, t_near]. Returns (t_near' [R, 1], t_far' [R, 1])."""
    K0 = nr_probe_steps
    seg = (t_far - t_near) / _steps(K0, t_far)
    occ = _probe(rays_o, rays_d, t_near, seg, K0, grid).to(torch.uint8)
    any_occ = torch.any(occ > 0, dim=1, keepdim=True)
    first = torch.argmax(occ, dim=1, keepdim=True).float()
    last = (K0 - 1) - torch.argmax(torch.flip(occ, dims=(1,)), dim=1, keepdim=True).float()
    t0 = torch.where(any_occ, t_near + first * seg, t_near)
    t1 = torch.where(any_occ, t_near + (last + 1.0) * seg, t_near)
    return t0, t1


def occupancy_samples_reference(rays_o, rays_d, t_near, t_far, grid, jitter,
                                min_dist_between_samples, min_nr_samples_per_ray,
                                max_nr_samples_per_ray, nr_march_steps, nr_probe_steps):
    """Plain version of ``occupancy_samples`` (same arguments and results)."""
    launches["occupancy_sampler_reference"] += 1
    R, S, K = rays_o.shape[0], max_nr_samples_per_ray, nr_march_steps
    if nr_probe_steps:
        t_near, t_far = rays_t_near_t_far_in_occupancy(rays_o, rays_d, t_near, t_far, grid,
                                                       nr_probe_steps)
    seg = (t_far - t_near) / _steps(K, t_far)
    occ = _probe(rays_o, rays_d, t_near, seg, K, grid)
    count = torch.cumsum(occ.to(torch.int32), dim=1)
    arc_incl = count.float() * seg  # occupied arc at the end of each step
    total_arc = arc_incl[:, -1:]
    nr, const_dist = _plan_sample_counts(total_arc, min_dist_between_samples, S,
                                         min_nr_samples_per_ray)
    i = torch.arange(S, dtype=torch.float32, device=rays_o.device)[None, :]
    s_target = (jitter + i) * const_dist
    # the first step whose arc at its end exceeds the target
    idx = torch.clamp(torch.searchsorted(arc_incl, s_target.contiguous(), right=True), max=K - 1)
    arc_before = (torch.gather(arc_incl, 1, idx)
                  - torch.gather(occ.float(), 1, idx) * seg)
    z = (t_near + idx.float() * seg) + (s_target - arc_before)
    z = torch.clamp(z, t_near, t_far)
    mask = (i < nr.float()) & (nr > 0) & (s_target < total_arc)
    return torch.where(mask, z, INVALID_Z), mask, t_near, t_far, const_dist


def occupancy_samples(rays_o, rays_d, t_near, t_far, grid, jitter, min_dist_between_samples,
                      min_nr_samples_per_ray, max_nr_samples_per_ray, nr_march_steps=512,
                      nr_probe_steps=0):
    """Samples inside the occupied space of grid (an ``OccupancyGrid``).

    rays [R, 3], t_near / t_far / jitter [R, 1] float32; nr_probe_steps 0
    skips the clipping. Returns (z [R, S], mask [R, S] bool, t_near'
    [R, 1], t_far' [R, 1], const_dist [R, 1]): the depths (INVALID_Z where
    the mask is False), the interval marched and the samples' spacing."""
    if not rays_o.is_cuda:
        return occupancy_samples_reference(
            rays_o, rays_d, t_near, t_far, grid, jitter, min_dist_between_samples,
            min_nr_samples_per_ray, max_nr_samples_per_ray, nr_march_steps, nr_probe_steps)
    dev = rays_o.device
    R, S = rays_o.shape[0], max_nr_samples_per_ray
    for name, t, shape in (("rays_o", rays_o, (R, 3)), ("rays_d", rays_d, (R, 3)),
                           ("t_near", t_near, (R, 1)), ("t_far", t_far, (R, 1)),
                           ("jitter", jitter, (R, 1))):
        _build.check_tensor(name, t, torch.float32, shape, dev)
    _build.check_tensor("grid.occupied", grid.occupied, torch.uint8, (grid.res,) * 3, dev)
    # the march's counts take 2 B a step of shared memory, 1 or 4 rays a block
    if nr_march_steps % 32 or nr_probe_steps % 32 or not 0 < nr_march_steps <= 2048:
        raise ValueError(f"occupancy_samples: step counts must be multiples of 32, the march "
                         f"at most 2048 (got {nr_march_steps}, {nr_probe_steps})")
    z = torch.empty(R, S, dtype=torch.float32, device=dev)
    mask = torch.empty(R, S, dtype=torch.uint8, device=dev)
    t0, t1, const_dist = (torch.empty(R, 1, dtype=torch.float32, device=dev) for _ in range(3))
    ex, ey, ez = grid.extent
    status = _build.kernels().vs_occupancy_samples(
        rays_o.data_ptr(), rays_d.data_ptr(), t_near.data_ptr(), t_far.data_ptr(),
        jitter.data_ptr(), grid.occupied.data_ptr(), z.data_ptr(), mask.data_ptr(),
        t0.data_ptr(), t1.data_ptr(), const_dist.data_ptr(), ex, ey, ez, grid.res,
        nr_march_steps, nr_probe_steps, S, min_dist_between_samples, min_nr_samples_per_ray,
        R, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "occupancy_samples")
    launches["occupancy_sampler"] += 1
    return z, mask.view(torch.bool), t0, t1, const_dist


def compute_samples_fg_in_occupied_regions(
    rays_o, rays_d, t_near, t_far, grid, min_dist_between_samples: float,
    min_nr_samples_per_ray: int, max_nr_samples_per_ray: int, jitter=None,
    nr_march_steps: int = 512, clip_to_occupancy: bool = False,
    nr_probe_steps: int | None = None,
) -> RaySamples:
    """Equispaced samples within the occupied space of grid only, from a
    jittered start (jitter [R, 1] in [0, 1), or None); with
    clip_to_occupancy the ray is first clipped to its occupied probes
    (nr_probe_steps, by default the march's own midpoints)."""
    if jitter is None:
        jitter = torch.zeros(rays_o.shape[0], 1, device=rays_o.device)
    probe = (nr_probe_steps or nr_march_steps) if clip_to_occupancy else 0
    z, mask, t0, t1, const_dist = occupancy_samples(
        rays_o.contiguous(), rays_d.contiguous(), t_near.contiguous(), t_far.contiguous(), grid,
        jitter.contiguous(), min_dist_between_samples, min_nr_samples_per_ray,
        max_nr_samples_per_ray, nr_march_steps, probe)
    out = RaySamples(z=z, dt=torch.zeros_like(z), mask=mask, rays_o=rays_o, rays_d=rays_d,
                     t_near=t0, t_far=t1, max_dt=const_dist)
    return update_dt(out, is_background=False)


def importance_refine(uniform: RaySamples, sdfs_at, logistic_beta, nr_imp_samples: int,
                      min_dist_between_samples: float, jitter_fn) -> RaySamples:
    """The NeuS samplers' two rounds of importance sampling, without
    gradient: n/2 depths from the SDFs of the uniform samples at half the
    beta, the uniform samples merged with them (the SDFs carried along),
    n/2 more from the merged set at the beta, then the new depths merged
    and merged into the uniform samples (kernels K8c and K8a on the card).
    sdfs_at(samples) gives the SDFs [R, S, K] (K surfaces) at the samples;
    jitter_fn() a round's jitter [R, n/2] or None."""
    half = nr_imp_samples // 2
    with torch.no_grad():
        sdfs_u = sdfs_at(uniform)
        imp1 = VR.neus_importance(uniform, sdfs_u, logistic_beta / 2.0, half, jitter_fn())
        combined, comb_sdfs = TS.combine(uniform, imp1, min_dist_between_samples, sdfs_u,
                                         sdfs_at(imp1))
        imp2 = VR.neus_importance(combined, comb_sdfs, logistic_beta, half, jitter_fn())
        imp, _ = TS.combine(imp1, imp2, min_dist_between_samples)
        final, _ = TS.combine(uniform, imp, min_dist_between_samples)
    return final


# ---- the background's samples ---------------------------------------------------

BG_T_FAR = 100.0  # where the background's samples end
CONTRACTION_SCALE = 2.0


def _norm3(x):
    """|x| over the last axis [..., 3] -> [..., 1], as JAX's norm rounds it."""
    return norm3(x)[..., None]


def _inverse_depths(t_start, nr_samples: int, t_far: float):
    """The un-jittered depths [R, N]: s = 1 - i / (N - 1), t = 1 / (s +
    1e-6) - 1 + t_start, clamped to [t_start, t_far]."""
    dev = t_start.device
    # 1 / (N - 1) rounded to float32 once, as JAX's weak-typed scalar
    delta_s = torch.tensor(1.0 / (nr_samples - 1), dtype=torch.float32, device=dev)
    s = 1.0 - delta_s * torch.arange(nr_samples, dtype=torch.float32, device=dev)[None, :]
    t = 1.0 / (s + 1e-6) - 1.0 + t_start
    return torch.minimum(torch.maximum(t, t_start), torch.full_like(t_start, t_far))


def compute_samples_bg(rays_o, rays_d, t_start, nr_samples_per_ray: int,
                       t_far: float = BG_T_FAR, jitter=None) -> RaySamples:
    """Background samples [R, N] with inverse-depth spacing from t_start
    [R, 1] to t_far. jitter [R, N] (uniform draws in [0, 1), or None) moves
    each middle sample toward the one before it: t_prev + (t - t_prev) u,
    the first and last unmoved. max_dt is the largest gap of a row; dt as
    ``update_dt`` gives a background ray (the last sample 1e10)."""
    R, N = rays_o.shape[0], nr_samples_per_ray
    t = _inverse_depths(t_start, N, t_far)
    if jitter is not None:
        t_prev = torch.cat([t_start.expand(R, 1), t[:, :-1]], dim=1)
        jittered = t_prev + (t - t_prev) * jitter
        i = torch.arange(N, device=t.device)[None, :]
        t = torch.where((i > 0) & (i < N - 1), jittered, t)
    dt = torch.diff(t, dim=1, prepend=t_start.expand(R, 1))
    max_dt = torch.amax(dt, dim=1, keepdim=True)
    out = RaySamples(z=t, dt=torch.zeros_like(t), mask=torch.ones_like(t, dtype=torch.bool),
                     rays_o=rays_o, rays_d=rays_d, t_near=t_start.expand(R, 1),
                     t_far=torch.full_like(t_start, t_far), max_dt=max_dt)
    return update_dt(out, is_background=True)


def contract_points(points, scale: float = CONTRACTION_SCALE):
    """mip-NeRF 360's contraction: points with |scale p| <= 1 stay; the
    others map to (2 - 1 / n) p / n, n = |scale p|, inside the ball of
    radius 2 / scale."""
    norm = _norm3(points * scale)
    safe = torch.clamp(norm, min=1e-12)
    factor = 2.0 - 1.0 / safe
    return torch.where(norm > 1.0, factor * points / safe, points)


def uncontract_points(points, scale: float = CONTRACTION_SCALE):
    """The inverse of ``contract_points``."""
    norm = _norm3(points * scale)
    factor = 1.0 / torch.clamp(2.0 - norm, min=1e-12)
    return torch.where(norm > 1.0, factor * points / torch.clamp(norm, min=1e-12), points)


def contract_samples(samples: RaySamples, scale: float = CONTRACTION_SCALE):
    """(contracted positions [R, S, 3], the samples with z the distance from
    the ray's origin to the contracted point): that distance need not grow
    along a ray, so ``update_dt`` clamps a negative gap to 0 (against the
    uncontracted max_dt); nothing is sorted."""
    cpos = contract_points(samples.positions(), scale)
    cz = _norm3(cpos - samples.rays_o[:, None, :])[..., 0]
    cz = torch.where(samples.mask, cz, INVALID_Z)
    return cpos, update_dt(samples.replace(z=cz), is_background=True)


def bg_samples_reference(rays_o, rays_d, t_start, nr_samples: int, jitter=None,
                         t_far: float = BG_T_FAR):
    """Plain version of ``contracted_bg_samples`` (same arguments and
    results): ``compute_samples_bg``, then ``contract_samples``."""
    launches["bg_samples_reference"] += 1
    samples = compute_samples_bg(rays_o, rays_d, t_start, nr_samples, t_far, jitter)
    cpos, c_samples = contract_samples(samples)
    return cpos, c_samples.dirs(), c_samples, samples.z


def contracted_bg_samples(rays_o, rays_d, t_start, nr_samples: int, jitter=None,
                          t_far: float = BG_T_FAR):
    """The background's samples of rays [R, 3] from t_start [R, 1] (the
    bounding primitive's far end; 0 for a ray that misses it) to t_far,
    contracted: (positions [R, N, 3] in the unit ball, directions [R, N, 3]
    (the rays' own, expanded),
    RaySamples of the contracted distances z [R, N] with their dt and the
    uncontracted max_dt, the uncontracted depths [R, N]). jitter [R, N] in
    [0, 1) or None (``compute_samples_bg``). No gradient flows to the rays.
    On the card N is 2 to ``BG_MAX_SAMPLES``."""
    if not rays_o.is_cuda:
        return bg_samples_reference(rays_o, rays_d, t_start, nr_samples, jitter, t_far)
    dev = rays_o.device
    R, N = rays_o.shape[0], nr_samples
    rays_o, rays_d, t_start = (x.detach().contiguous() for x in (rays_o, rays_d, t_start))
    checks = [("rays_o", rays_o, (R, 3)), ("rays_d", rays_d, (R, 3)), ("t_start", t_start, (R, 1))]
    if jitter is not None:
        jitter = jitter.contiguous()
        checks.append(("jitter", jitter, (R, N)))
    for name, t, shape in checks:
        _build.check_tensor(name, t, torch.float32, shape, dev)
    if not 2 <= N <= BG_MAX_SAMPLES:
        raise ValueError(f"contracted_bg_samples: at least 2 and at most {BG_MAX_SAMPLES} "
                         f"samples a ray on the card, a row to a block (got {N})")
    cpos = torch.empty(R, N, 3, dtype=torch.float32, device=dev)
    cz, dt, z = (torch.empty(R, N, dtype=torch.float32, device=dev) for _ in range(3))
    max_dt = torch.empty(R, 1, dtype=torch.float32, device=dev)
    status = _build.kernels().vs_bg_samples(
        rays_o.data_ptr(), rays_d.data_ptr(), t_start.data_ptr(),
        None if jitter is None else jitter.data_ptr(), float(np.float32(1.0 / (N - 1))),
        t_far, cpos.data_ptr(), cz.data_ptr(), dt.data_ptr(), z.data_ptr(),
        max_dt.data_ptr(), N, R, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "bg_samples")
    launches["bg_samples"] += 1
    c_samples = RaySamples(z=cz, dt=dt, mask=torch.ones(R, N, dtype=torch.bool, device=dev),
                           rays_o=rays_o, rays_d=rays_d, t_near=t_start,
                           t_far=torch.full_like(t_start, t_far), max_dt=max_dt)
    return cpos, c_samples.dirs(), c_samples, z
