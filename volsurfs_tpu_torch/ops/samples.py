"""Dense per-ray samples (counterpart of volsurfs_tpu/ops/samples.py).

A batch of R rays holds up to S samples each as [R, S] tensors: depths
``z``, their spacing ``dt`` and a validity ``mask``. The valid samples of
a row form a prefix sorted by depth; invalid slots hold ``INVALID_Z``.
"""

from __future__ import annotations

import dataclasses

import torch

# depth stored in invalid slots; sorts after any real sample
INVALID_Z = 1e10


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


def combine(a: RaySamples, b: RaySamples, min_dist_between_samples: float,
            values_a=None, values_b=None):
    """Merge two sample sets of the same rays, sorted by depth; a sample
    closer than min_dist_between_samples to the last one kept is dropped
    (the sequential keep-chain, one step a slot: S_a + S_b launches of a few
    elementwise ops). Returns (samples with S_a + S_b slots, the merged
    values or None)."""
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
