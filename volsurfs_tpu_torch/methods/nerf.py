"""``nerf`` method: an occupancy-pruned volumetric density field.
Counterpart of volsurfs_tpu/methods/nerf.py.

A train step samples each ray inside the occupied space of the occupancy
grid (kernel K7), refines the samples by one round of importance sampling
on the density (without gradients; kernel K8d, then K8a merges the new
depths into the uniform ones), evaluates the density and the SH colour
field at the samples (the permutohedral encoder, kernel K6) and composites
them with NeRF alphas, clip(1 - exp(-sigma dt), 0, 1), whose transmittance
scan is kernel K8b's. The background takes the scan's ``bg_transmittance``:
a constant colour, or with ``bg_color`` None (the default) or "trained" the
``NerfHash`` field over the contracted space (``render_contracted_bg``,
kernel K10's samples, jittered by a draw after the samplers' in training).
The occupancy refresh evaluates the density at jittered voxel centres, keeps
the larger of it and 0.8 times the old value, and marks a voxel occupied
above a density of 1e-4.

Random numbers (the sampler's start jitter, the importance-sampling jitter,
the sparsity term's random points and the refresh's voxel jitter) are drawn
from ``self.generator`` in JAX's order, by ``_uniform``, the bounding
primitive's ``get_random_points_inside`` and the grid's
``get_grid_samples``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from volsurfs_tpu_torch.methods.base import (grad_norms, make_background, make_optimizer,
                                             render_background)
from volsurfs_tpu_torch.methods.volsurfs import resolve_device
from volsurfs_tpu_torch.models.fields import RGB, Density
from volsurfs_tpu_torch.ops import raycast as RC
from volsurfs_tpu_torch.ops import samplers as SP
from volsurfs_tpu_torch.ops import samples as TS
from volsurfs_tpu_torch.ops import volume_rendering as VR
from volsurfs_tpu_torch.ops.occupancy import make_grid
from volsurfs_tpu_torch.utils import losses as L

class NeRF:
    method_name = "nerf"
    # the sparsity term acts after this step, JAX's hard-coded gate
    sparsity_start_iter = 5000
    nr_sparsity_points = 1024  # random points a step of the sparsity term
    refresh_chunk = 65536  # voxels a chunk of the occupancy refresh

    def __init__(
        self,
        hyper_params,
        bounding_primitive,
        bg_color: Optional[str] = None,
        occupancy_res: int = 256,
        device="cuda",
        seed: int = 0,
    ):
        self.device = resolve_device(device)
        self.hp = hp = hyper_params
        self.bounding_primitive = bounding_primitive
        self.occupancy_res = occupancy_res
        self.radius = radius = float(bounding_primitive.get_radius())

        generator = torch.Generator().manual_seed(seed)
        density = Density(mlp_layers_dims=tuple(hp.density_mlp_layers_dims),
                          encoding_type=hp.density_encoding_type,
                          geom_feat_size=hp.geom_feat_size,
                          nr_iters_for_c2f=hp.density_nr_iters_for_c2f, bb_sides=radius * 2.0,
                          generator=generator)
        # a density field has no normals: the colour field never takes them
        rgb = RGB(mlp_layers_dims=tuple(hp.rgb_mlp_layers_dims),
                  pos_encoder_type=hp.rgb_pos_encoder_type, sh_deg=hp.sh_degree,
                  view_dep=hp.rgb_view_dep, normal_dep=False,
                  geom_feat_dep=hp.rgb_geom_feat_dep, in_geom_feat_size=hp.geom_feat_size,
                  nr_iters_for_c2f=hp.rgb_nr_iters_for_c2f, bb_sides=radius * 2.0,
                  mlp_dtype="bfloat16" if hp.use_grad_scaler else None, generator=generator)
        self.bg_color, bg = make_background(bg_color, hp, self.device, generator)
        models = {"density": density, "rgb": rgb}
        if bg is not None:
            models["bg"] = bg
        self.models = nn.ModuleDict(models).to(self.device)
        self.optimizer, self.scheduler = make_optimizer(hp, self.models.parameters(),
                                                        warmup_start_iter=0)
        self.grid = None
        if hp.use_occupancy_grid:
            self.grid = make_grid(occupancy_res, radius * 2.0, sphere_roi_radius=radius,
                                  device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.iter_nr = 0

    def _uniform(self, shape, low: float = 0.0, high: float = 1.0):
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return u if (low, high) == (0.0, 1.0) else u * (high - low) + low

    def _density(self, points, iter_nr):
        return self.models["density"](points, iter_nr)

    # ---- sampling ---------------------------------------------------------------

    def _sample_rays(self, rays_o, rays_d, t_near, t_far, iter_nr, jitter: bool):
        """Samples in the occupied space (or the whole interval without a
        grid), then one round of importance sampling on the density, merged
        into them, without gradients."""
        hp = self.hp
        R = rays_o.shape[0]
        start = self._uniform((R, 1)) if jitter else None
        if self.grid is not None:
            uniform = SP.compute_samples_fg_in_occupied_regions(
                rays_o, rays_d, t_near, t_far, self.grid, hp.min_dist_between_samples,
                hp.min_nr_samples_per_ray, hp.max_nr_samples_per_ray, jitter=start,
                clip_to_occupancy=hp.clip_rays_to_occupancy)
        else:
            uniform = SP.compute_samples_fg(
                rays_o, rays_d, t_near, t_far, hp.min_dist_between_samples,
                hp.min_nr_samples_per_ray, hp.max_nr_samples_per_ray, jitter=start)
        if not hp.do_importance_sampling:
            return uniform
        n = hp.max_nr_imp_samples_per_ray
        with torch.no_grad():
            density, _ = self._density(uniform.positions(), iter_nr)
            imp_jitter = self._uniform((R, n), -0.5, 0.5) if jitter else None
            imp = VR.nerf_importance(uniform, density, n, imp_jitter)
            final, _ = TS.combine(uniform, imp, hp.min_dist_between_samples)
        return final

    # ---- rendering ------------------------------------------------------------

    def render_rays(self, rays_o, rays_d, iter_nr=None, train: bool = False) -> dict:
        """Volumetric render of rays [R, 3]; differentiable w.r.t. both
        fields' parameters. train jitters the samples."""
        iter_nr = self.iter_nr if iter_nr is None else iter_nr
        raycast = RC.intersect_bounding_primitive(self.bounding_primitive, rays_o, rays_d)
        samples = self._sample_rays(rays_o, rays_d, raycast["t_near"], raycast["t_far"],
                                    iter_nr, jitter=train)
        pos = samples.positions()
        density, geom_feat = self._density(pos, iter_nr)
        rgb_samples = self.models["rgb"](pos, samples.dirs(), None, geom_feat, iter_nr)
        weights, bg_transmittance = VR.nerf_weights(samples, density)
        weights_sum, _ = VR.sum_over_rays(weights, samples.mask)
        rgb_fg = VR.integrate(rgb_samples, weights, samples.mask)
        depth_fg = VR.integrate(samples.z[..., None], weights, samples.mask)
        rgb_bg, depth_bg = render_background(self, raycast, rays_o.shape[0], iter_nr, train)
        return {
            "rgb": rgb_fg + bg_transmittance * rgb_bg,
            "rgb_fg": rgb_fg,
            "rgb_bg": rgb_bg,
            "depth": depth_fg * weights_sum + depth_bg * bg_transmittance,
            "weights_sum": weights_sum,
            "bg_transmittance": bg_transmittance,
            "nr_samples": samples.samples_per_ray(),
        }

    # ---- loss and steps ---------------------------------------------------------

    def _loss(self, batch, iter_nr):
        hp = self.hp
        res = self.render_rays(batch["rays_o"], batch["rays_d"], iter_nr, train=True)
        pred_rgb, pred_mask = res["rgb"], res["weights_sum"]
        if hp.nr_training_rays_per_pixel > 1:
            pred_rgb = pred_rgb.reshape(-1, hp.nr_training_rays_per_pixel, 3).mean(1)
            pred_mask = pred_mask.reshape(-1, hp.nr_training_rays_per_pixel, 1).mean(1)
        mask = batch["gt_mask"] if hp.is_training_masked else None
        loss_rgb = L.loss_l1(batch["gt_rgb"], pred_rgb, mask=mask)
        loss = loss_rgb
        zero = torch.zeros((), device=self.device)

        loss_sparsity = zero
        if hp.sparsity_weight > 0.0:
            # drawn at every step, as JAX draws them; evaluated only where
            # the gate is open (JAX multiplies the term by 0 before it)
            points = self.bounding_primitive.get_random_points_inside(
                self.generator, self.nr_sparsity_points)
            if iter_nr > self.sparsity_start_iter:
                density, _ = self._density(points, iter_nr)
                loss_sparsity = L.sparsity_loss(density) * hp.sparsity_weight
                loss = loss + loss_sparsity

        loss_mask = zero
        if hp.is_training_masked and hp.mask_weight > 0.0:
            pm = torch.clamp(pred_mask, 0.0, 1.0)
            loss_mask = (L.loss_l1(pm, batch["gt_mask"], mask=1.0 - batch["gt_mask"])
                         * hp.mask_weight)
            loss = loss + loss_mask

        return loss, {"loss": loss, "rgb": loss_rgb, "sparsity": loss_sparsity, "mask": loss_mask,
                      "nr_samples_total": torch.sum(res["nr_samples"])}

    def train_step(self, batch) -> dict:
        """One Adam step on the data loss. Returns the losses and the
        gradient norms as 0-d tensors (no host sync)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, losses = self._loss(batch, self.iter_nr)
        loss.backward()
        # a parameter the loss does not reach takes a zero gradient, so that
        # Adam's moments and step count advance for every parameter, as
        # optax's do
        for p in self.models.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        losses.update(grad_norms(self.models))
        self.optimizer.step()
        self.scheduler.step()
        self.iter_nr += 1
        return {k: v.detach() for k, v in losses.items()}

    def update_occupancy_grid(self):
        """Re-evaluate the density at jittered voxel centres (refresh_chunk
        voxels a chunk, each chunk's jitter drawn beside it), keep the
        larger of it and 0.8 times the old value, and mark the voxels above
        a density of 1e-4 occupied."""
        if self.grid is None:
            return
        grid = self.grid
        n = grid.res ** 3
        chunk = min(n, self.refresh_chunk)
        with torch.no_grad():
            density = torch.cat([
                self._density(grid.get_grid_samples(s, min(s + chunk, n), self.generator),
                              self.iter_nr)[0][..., 0]
                for s in range(0, n, chunk)])
        grid = grid.update_values(density, decay=0.8)
        self.grid = grid.update_occupancy_with_density(occupancy_thresh=1e-4)

    def make_render_fn(self):
        """fn(rays_o, rays_d) -> {"rgb", "depth", "weights_sum"}, the
        volumetric render at the method's iter_nr, without autograd."""

        def render(rays_o, rays_d):
            with torch.no_grad():
                res = self.render_rays(rays_o, rays_d, self.iter_nr, train=False)
            return {k: res[k] for k in ("rgb", "depth", "weights_sum")}

        return render
