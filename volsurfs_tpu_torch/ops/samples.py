"""Dense per-ray samples (counterpart of volsurfs_tpu/ops/samples.py).

A batch of R rays holds up to S samples each as [R, S] tensors: depths
``z``, their spacing ``dt`` and a validity ``mask``. The valid samples of
a row form a prefix sorted by depth; invalid slots hold ``INVALID_Z``.

``combine`` (the merge of two sample sets) is kernel K8a
(``csrc/volrender.cu``, a warp a ray: a merge by ranks, the keep-chain by
successors and pointer doubling) on a CUDA tensor and the plain version
``combine_reference`` on a CPU tensor; the two agree bit for bit on any
row, sorted or not.
"""

from __future__ import annotations

import dataclasses

import torch

from volsurfs_tpu_torch import _build

# depth stored in invalid slots; sorts after any real sample
INVALID_Z = 1e10

# launch counts: the CUDA kernel's and the plain version's
launches = {"combine_samples": 0, "combine_samples_reference": 0}


def batched_searchsorted(bins, queries, side: str = "right"):
    """Row-wise searchsorted of queries [R, S] in sorted rows bins [R, K]."""
    return torch.searchsorted(bins.contiguous(), queries.contiguous(),
                              right=side == "right").to(torch.int32)


@dataclasses.dataclass
class RaySamples:
    z: torch.Tensor  # [R, S] depths (ascending, INVALID_Z pad)
    dt: torch.Tensor  # [R, S] distance to the next sample
    mask: torch.Tensor  # [R, S] bool, a prefix of each row
    rays_o: torch.Tensor  # [R, 3]
    rays_d: torch.Tensor  # [R, 3] unit directions
    t_near: torch.Tensor  # [R, 1]
    t_far: torch.Tensor  # [R, 1]
    max_dt: torch.Tensor  # [R, 1] nominal spacing; dt is clamped to it

    @property
    def num_rays(self) -> int:
        return self.z.shape[0]

    @property
    def max_samples(self) -> int:
        return self.z.shape[1]

    def replace(self, **changes) -> "RaySamples":
        return dataclasses.replace(self, **changes)

    def positions(self):
        """[R, S, 3] world-space sample positions."""
        return self.rays_o[:, None, :] + self.z[..., None] * self.rays_d[:, None, :]

    def dirs(self):
        """[R, S, 3] the ray direction of every sample."""
        return self.rays_d[:, None, :].expand(*self.z.shape, 3)

    def samples_per_ray(self):
        """[R, 1] int32 number of valid samples."""
        return torch.sum(self.mask, dim=1, keepdim=True).to(torch.int32)


def update_dt(samples: RaySamples, is_background: bool = False) -> RaySamples:
    """dt_i = clamp(z_{i+1} - z_i, 0, max_dt); the last valid sample takes
    clamp(t_far - z, 0, max_dt) (1e10 for a background ray)."""
    z = torch.where(samples.mask, samples.z, INVALID_Z)
    next_z = torch.cat([z[:, 1:], torch.full_like(z[:, :1], INVALID_Z)], dim=1)
    next_valid = torch.cat([samples.mask[:, 1:], torch.zeros_like(samples.mask[:, :1])], dim=1)
    is_last_valid = samples.mask & ~next_valid
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    dt_mid = torch.clamp(next_z - z, zero, samples.max_dt)
    if is_background:
        dt_last = torch.full_like(z, 1e10)
    else:
        dt_last = torch.clamp(samples.t_far - z, zero, samples.max_dt)
    dt = torch.where(is_last_valid, dt_last, dt_mid)
    dt = torch.where(samples.mask, dt, 0.0)
    return samples.replace(dt=dt)


def sort_by_z(samples: RaySamples, values=None):
    """Sort each ray's samples by depth, invalid slots last; values [R, S,
    C] (optional) are permuted alike. Returns (samples, values or None)."""
    z_key = torch.where(samples.mask, samples.z, INVALID_Z)
    order = torch.argsort(z_key, dim=1, stable=True)
    out = samples.replace(
        z=torch.gather(z_key, 1, order),
        mask=torch.gather(samples.mask, 1, order),
        dt=torch.gather(samples.dt, 1, order),
    )
    if values is None:
        return out, None
    return out, torch.gather(values, 1, order[..., None].expand(-1, -1, values.shape[-1]))


def _take(x, order):
    if x.ndim == 2:
        return torch.gather(x, 1, order)
    return torch.gather(x, 1, order[..., None].expand(-1, -1, x.shape[-1]))


def combine_reference(a: RaySamples, b: RaySamples, min_dist_between_samples: float,
                      values_a=None, values_b=None):
    """Plain version of ``combine``: two stable argsorts around the
    sequential keep-chain (one step a slot: S_a + S_b launches of a few
    elementwise ops)."""
    launches["combine_samples_reference"] += 1
    z = torch.cat([torch.where(a.mask, a.z, INVALID_Z), torch.where(b.mask, b.z, INVALID_Z)], 1)
    mask = torch.cat([a.mask, b.mask], dim=1)
    order = torch.argsort(z, dim=1, stable=True)
    z = torch.gather(z, 1, order)
    mask = torch.gather(mask, 1, order)
    values = None
    if values_a is not None or values_b is not None:
        assert values_a is not None and values_b is not None
        values = _take(torch.cat([values_a, values_b], dim=1), order)

    last_kept = torch.full(z.shape[:1], -1e10, dtype=z.dtype, device=z.device)
    keeps = []
    for i in range(z.shape[1]):
        keep = mask[:, i] & ((z[:, i] - last_kept) >= min_dist_between_samples)
        last_kept = torch.where(keep, z[:, i], last_kept)
        keeps.append(keep)
    mask = torch.stack(keeps, dim=1)

    z = torch.where(mask, z, INVALID_Z)
    order2 = torch.argsort(z, dim=1, stable=True)
    z = torch.gather(z, 1, order2)
    mask = torch.gather(mask, 1, order2)
    if values is not None:
        values = _take(values, order2)
    out = RaySamples(
        z=z, dt=torch.zeros_like(z), mask=mask, rays_o=a.rays_o, rays_d=a.rays_d,
        t_near=a.t_near, t_far=a.t_far, max_dt=torch.maximum(a.max_dt, b.max_dt),
    )
    return update_dt(out, is_background=False), values


def combine(a: RaySamples, b: RaySamples, min_dist_between_samples: float,
            values_a=None, values_b=None):
    """Merge two sample sets of the same rays, sorted by depth (ties: a's
    first); a sample closer than min_dist_between_samples to the last one
    kept is dropped. The S_a + S_b slots of a row hold the kept samples by
    depth, then the dropped valid ones in merge order, then a's invalid
    slots, then b's; values [R, S_a, C] and [R, S_b, C] (optional) follow
    their samples. dt as ``update_dt`` gives it, max_dt the larger of the
    two. Returns (samples, the merged values or None); no gradient flows
    through either (both samplers run it under no_grad)."""
    if not a.z.is_cuda:
        return combine_reference(a, b, min_dist_between_samples, values_a, values_b)
    if (values_a is None) != (values_b is None):
        raise ValueError("combine: give the values of both sample sets or of neither")
    dev = a.z.device
    R, Sa = a.z.shape
    Sb = b.z.shape[1]
    S = Sa + Sb
    za, zb = a.z.contiguous(), b.z.contiguous()
    ma, mb = a.mask.contiguous(), b.mask.contiguous()
    t_far, mda, mdb = a.t_far.contiguous(), a.max_dt.contiguous(), b.max_dt.contiguous()
    C = 0 if values_a is None else values_a.shape[-1]
    checks = [("a.z", za, torch.float32, (R, Sa)), ("b.z", zb, torch.float32, (R, Sb)),
              ("a.mask", ma, torch.bool, (R, Sa)), ("b.mask", mb, torch.bool, (R, Sb)),
              ("a.t_far", t_far, torch.float32, (R, 1)), ("a.max_dt", mda, torch.float32, (R, 1)),
              ("b.max_dt", mdb, torch.float32, (R, 1))]
    if C:
        values_a, values_b = values_a.contiguous(), values_b.contiguous()
        checks += [("values_a", values_a, torch.float32, (R, Sa, C)),
                   ("values_b", values_b, torch.float32, (R, Sb, C))]
    for name, t, dtype, shape in checks:
        _build.check_tensor(name, t, dtype, shape, dev)
    if S > 4096:
        raise ValueError(f"combine: at most 4096 slots a ray (got {S})")
    z = torch.empty(R, S, dtype=torch.float32, device=dev)
    mask = torch.empty(R, S, dtype=torch.bool, device=dev)
    dt = torch.empty(R, S, dtype=torch.float32, device=dev)
    max_dt = torch.empty(R, 1, dtype=torch.float32, device=dev)
    values = torch.empty(R, S, C, dtype=torch.float32, device=dev) if C else None
    status = _build.kernels().vs_combine_samples(
        za.data_ptr(), ma.data_ptr(), zb.data_ptr(), mb.data_ptr(),
        values_a.data_ptr() if C else None, values_b.data_ptr() if C else None,
        t_far.data_ptr(), mda.data_ptr(), mdb.data_ptr(), min_dist_between_samples,
        z.data_ptr(), mask.data_ptr(), dt.data_ptr(), values.data_ptr() if C else None,
        max_dt.data_ptr(), Sa, Sb, C, R, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "combine_samples")
    launches["combine_samples"] += 1
    out = RaySamples(z=z, dt=dt, mask=mask, rays_o=a.rays_o, rays_d=a.rays_d, t_near=a.t_near,
                     t_far=a.t_far, max_dt=max_dt)
    return out, values
