"""Dense occupancy grid: values, occupancy and region-of-interest masks
(counterpart of volsurfs_tpu/ops/occupancy.py).

Grids are row-major [res, res, res] tensors centred on the origin. The grid
is immutable, as JAX's: the updates return a new grid. Each grid also keeps
``occupied``, one uint8 a voxel of ``occupancy & roi``, made when the grid
is made: the byte grid the occupancy sampler (kernel K7) reads, refreshed
once per occupancy update.
"""

from __future__ import annotations

import dataclasses

import torch


def logistic_pdf(x, beta):
    """Logistic density of NeuS: beta e / (1 + e)^2, e = exp(-beta x)."""
    exp_term = torch.clamp(torch.exp(-beta * x), -1e6, 1e6)
    return beta * exp_term / (1.0 + exp_term) ** 2


def _norm3(x):
    """sqrt(x0^2 + x1^2 + x2^2), summed left to right."""
    sq = x * x
    return torch.sqrt(sq[..., 0] + sq[..., 1] + sq[..., 2])


@dataclasses.dataclass
class OccupancyGrid:
    values: torch.Tensor  # [res, res, res] float32 (|sdf| or density at the voxels)
    occupancy: torch.Tensor  # [res, res, res] bool
    roi: torch.Tensor  # [res, res, res] bool
    extent: tuple  # world-space side lengths (float32 values)
    occupied: torch.Tensor = dataclasses.field(init=False, repr=False)
    # the extent on the grid's device, copied there once a grid: a copy
    # from the host waits for the device's queue to drain
    _extent: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.occupied = (self.occupancy & self.roi).to(torch.uint8).contiguous()
        self._extent = torch.tensor(self.extent, dtype=torch.float32, device=self.device)

    @property
    def res(self) -> int:
        return self.values.shape[0]

    @property
    def device(self):
        return self.values.device

    def extent_tensor(self):
        return self._extent

    def voxel_size(self):
        return self.extent_tensor() / self.res

    def voxel_centers(self, start: int = 0, stop: int | None = None):
        """World-space centres of the voxels start..stop-1 of the row-major
        order (all of them by default): [stop - start, 3], the points at
        which a refresh evaluates the field (JAX's ``get_grid_samples``)."""
        res = self.res
        stop = res ** 3 if stop is None else stop
        lin = torch.arange(start, stop, device=self.device)
        ijk = torch.stack([lin // (res * res), (lin // res) % res, lin % res], dim=-1)
        return ((ijk.float() + 0.5) / res - 0.5) * self.extent_tensor()

    def get_grid_samples(self, start: int = 0, stop: int | None = None,
                         generator: torch.Generator | None = None):
        """The voxel centres start..stop-1 (``voxel_centers``), each moved by
        a uniform draw in [-0.5, 0.5) times the voxel size from generator
        ([stop - start, 3], three draws a point), or unmoved without one:
        the points at which the nerf method's refresh evaluates its
        density. A caller draws the grid in chunks, in order."""
        centers = self.voxel_centers(start, stop)
        if generator is None:
            return centers
        u = torch.rand(centers.shape, generator=generator, device=self.device)
        return centers + (u - 0.5) * self.voxel_size()

    def pos_to_voxel_idx(self, points):
        """[N, 3] world positions -> ([N, 3] int32 voxel coords clamped into
        the grid, [N] in bounds)."""
        normalized = points / self.extent_tensor() + 0.5
        coords = torch.floor(normalized * self.res).to(torch.int32)
        in_bounds = torch.all((coords >= 0) & (coords < self.res), dim=-1)
        return torch.clamp(coords, 0, self.res - 1), in_bounds

    def check_occupancy(self, points):
        """[N, 3] -> [N] bool: the point lies in an occupied voxel of the ROI."""
        coords, in_bounds = self.pos_to_voxel_idx(points)
        c = coords.long()
        occ = self.occupied[c[:, 0], c[:, 1], c[:, 2]].bool()
        return occ & in_bounds

    def occupancy_fraction(self):
        """Fraction of the ROI's voxels that are occupied (0-d tensor)."""
        roi_count = torch.clamp(torch.sum(self.roi), min=1)
        return torch.sum(self.occupied) / roi_count

    def update_values(self, new_values, decay: float = 0.0) -> "OccupancyGrid":
        """values <- max(new, old * decay); new_values [res^3] or [res^3, 1]
        in the order of ``voxel_centers``."""
        new_values = new_values.reshape(self.values.shape)
        return dataclasses.replace(self, values=torch.maximum(new_values, self.values * decay))

    def update_occupancy_with_density(self, occupancy_thresh: float = 1e-4):
        """Occupied iff the voxel's value (a density) exceeds the threshold."""
        return dataclasses.replace(self, occupancy=self.values > occupancy_thresh)

    def update_occupancy_with_sdf(self, logistic_beta, occupancy_thresh: float = 1e-4):
        """Occupied iff the logistic density of the smallest |sdf| the voxel
        can hold (|value| less half its diagonal) exceeds the threshold."""
        half_diag = 0.5 * _norm3(self.voxel_size())
        min_dist = torch.clamp(torch.abs(self.values) - half_diag, 0.0, 1e10)
        weight = logistic_pdf(min_dist, logistic_beta)
        return dataclasses.replace(self, occupancy=weight > occupancy_thresh)


def make_grid(res: int, extent, sphere_roi_radius: float | None = None,
              device="cpu") -> OccupancyGrid:
    """An all-occupied grid of res^3 voxels spanning extent (a side length
    or three), its ROI the ball of sphere_roi_radius if given."""
    ext = torch.broadcast_to(torch.as_tensor(extent, dtype=torch.float32), (3,))
    shape = (res, res, res)
    values = torch.zeros(shape, dtype=torch.float32, device=device)
    occupancy = torch.ones(shape, dtype=torch.bool, device=device)
    grid = OccupancyGrid(values, occupancy, occupancy, tuple(float(x) for x in ext))
    if sphere_roi_radius is not None:
        roi = _norm3(grid.voxel_centers()) <= sphere_roi_radius
        grid = dataclasses.replace(grid, roi=roi.reshape(shape))
    return grid
