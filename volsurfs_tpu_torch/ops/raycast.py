"""Bounding sphere and ray intersection (counterpart of
volsurfs_tpu/ops/raycast.py; the bounding box waits for the surf slice)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class BoundingSphere:
    center: torch.Tensor  # [3]
    radius: float

    def get_radius(self) -> float:
        return self.radius

    def get_center(self):
        return self.center

    def intersect(self, rays_o, rays_d):
        """Ray-sphere intersection. Rays starting inside get t_near = 0."""
        oc = rays_o - self.center.to(rays_o.device)[None, :]
        b = torch.sum(oc * rays_d, dim=-1)
        c = torch.sum(oc * oc, dim=-1) - self.radius**2
        disc = b * b - c
        is_hit = disc >= 0.0
        sqrt_disc = torch.sqrt(torch.clamp(disc, min=0.0))
        t0 = -b - sqrt_disc
        t1 = -b + sqrt_disc
        is_hit = is_hit & (t1 > 0.0)
        t_near = torch.where(is_hit, torch.clamp(t0, min=0.0), 0.0)
        t_far = torch.where(is_hit, torch.clamp(t1, min=0.0), 0.0)
        p_near = rays_o + t_near[:, None] * rays_d
        p_far = rays_o + t_far[:, None] * rays_d
        return is_hit, t_near, t_far, p_near, p_far


def make_bounding_sphere(radius: float, center=(0.0, 0.0, 0.0)) -> BoundingSphere:
    return BoundingSphere(
        center=torch.tensor(center, dtype=torch.float32), radius=float(radius)
    )


def intersect_bounding_primitive(bounding_primitive, rays_o, rays_d) -> dict:
    is_hit, t_near, t_far, p_near, p_far = bounding_primitive.intersect(
        rays_o, rays_d
    )
    return {
        "rays_o": rays_o,
        "rays_d": rays_d,
        "nr_rays": rays_o.shape[0],
        "points_near": p_near,
        "points_far": p_far,
        "t_near": t_near[:, None],
        "t_far": t_far[:, None],
        "is_hit": is_hit,
    }
