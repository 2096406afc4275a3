"""Bounding sphere and box: ray intersection and random points inside
(counterpart of volsurfs_tpu/ops/raycast.py)."""

from __future__ import annotations

import dataclasses

import torch

from volsurfs_tpu_torch.utils.math import norm3


def _on(cache: dict, t: torch.Tensor, device) -> torch.Tensor:
    """t on device, copied there once: a copy from the host waits for the
    device's queue to drain, and the primitives are used at every step."""
    device = torch.device(device)
    if device not in cache:
        cache[device] = t.to(device)
    return cache[device]


@dataclasses.dataclass
class BoundingSphere:
    center: torch.Tensor  # [3]
    radius: float
    _centers: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                       compare=False)

    def get_radius(self) -> float:
        return self.radius

    def get_center(self):
        return self.center

    def intersect(self, rays_o, rays_d):
        """Ray-sphere intersection. Rays starting inside get t_near = 0."""
        oc = rays_o - _on(self._centers, self.center, rays_o.device)[None, :]
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

    def points_from_draws(self, normals, uniforms):
        """Points inside the sphere from normal draws [N, 3] (the direction)
        and uniform draws [N, 1] in [0, 1) (the radius, as u^(1/3))."""
        dirs = normals / torch.linalg.norm(normals, dim=-1, keepdim=True)
        r = self.radius * uniforms ** (1.0 / 3.0)
        return _on(self._centers, self.center, normals.device)[None, :] + dirs * r

    def contains(self, points):
        """[N, 3] -> [N] bool: |p - center| <= radius (the norm rounded as
        JAX's)."""
        return norm3(points - _on(self._centers, self.center, points.device)[None, :]) \
            <= self.radius

    def get_random_points_inside(self, generator: torch.Generator, nr_points: int):
        """nr_points uniform points inside the sphere, on the generator's
        device."""
        normals = torch.randn(nr_points, 3, generator=generator, device=generator.device)
        uniforms = torch.rand(nr_points, 1, generator=generator, device=generator.device)
        return self.points_from_draws(normals, uniforms)


@dataclasses.dataclass
class BoundingBox:
    center: torch.Tensor  # [3]
    sides: torch.Tensor  # [3] full side lengths
    _centers: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                       compare=False)
    _sides: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                     compare=False)

    def _center_sides(self, device):
        return _on(self._centers, self.center, device), _on(self._sides, self.sides, device)

    def get_radius(self) -> float:
        """Radius of the circumscribed sphere."""
        return float(0.5 * torch.linalg.norm(self.sides))

    def get_center(self):
        return self.center

    def intersect(self, rays_o, rays_d):
        """Slab test; rays starting inside get t_near = 0."""
        center, sides = self._center_sides(rays_o.device)
        half = 0.5 * sides[None, :]
        center = center[None, :]
        lo, hi = center - half, center + half
        inv_d = 1.0 / torch.where(torch.abs(rays_d) < 1e-12, 1e-12, rays_d)
        t_lo = (lo - rays_o) * inv_d
        t_hi = (hi - rays_o) * inv_d
        t_min = torch.amax(torch.minimum(t_lo, t_hi), dim=-1)
        t_max = torch.amin(torch.maximum(t_lo, t_hi), dim=-1)
        is_hit = (t_max >= t_min) & (t_max > 0.0)
        t_near = torch.where(is_hit, torch.clamp(t_min, min=0.0), 0.0)
        t_far = torch.where(is_hit, torch.clamp(t_max, min=0.0), 0.0)
        p_near = rays_o + t_near[:, None] * rays_d
        p_far = rays_o + t_far[:, None] * rays_d
        return is_hit, t_near, t_far, p_near, p_far

    def get_random_points_inside(self, generator: torch.Generator, nr_points: int):
        u = torch.rand(nr_points, 3, generator=generator, device=generator.device) - 0.5
        center, sides = self._center_sides(u.device)
        return center[None, :] + u * sides[None, :]

    def contains(self, points):
        """[N, 3] -> [N] bool: |p - center| <= sides / 2 on every axis."""
        center, sides = self._center_sides(points.device)
        return torch.all(torch.abs(points - center[None, :]) <= 0.5 * sides[None, :], dim=-1)


def make_bounding_box(sides, center=(0.0, 0.0, 0.0)) -> BoundingBox:
    return BoundingBox(
        center=torch.tensor(center, dtype=torch.float32),
        sides=torch.broadcast_to(torch.as_tensor(sides, dtype=torch.float32), (3,)).clone(),
    )


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
