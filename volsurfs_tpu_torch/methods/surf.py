"""``surf`` method: NeuS-style single-SDF surface reconstruction.
Counterpart of volsurfs_tpu/methods/surf.py.

A train step samples each ray inside the occupied space of the occupancy
grid (kernel K7), refines the samples by two rounds of SDF importance
sampling (without gradients; kernels K8c and K8a), evaluates the SDF with
its analytic spatial gradient (the permutohedral encoder's Jacobian, kernel
K6, carried through the MLP) and the SH colour field at the samples, and
composites them with NeuS alphas (the transmittance scan is kernel K8b). K6's
backward accumulates both fields' table gradients. The
first ``init_phase_end_iter`` steps fit the SDF to a sphere instead. The
variance and cos-anneal schedules are numpy float32 scalars of ``iter_nr``.

Random numbers (the sampler's start jitter, the importance-sampling jitter,
the regulariser's random points and the curvature directions) are drawn
from ``self.generator`` in JAX's order, by ``_uniform`` and ``_normal`` and
the bounding primitive's ``get_random_points_inside``.

The colour field is ``ColorSH`` (``appearance_predict_sh_coeffs``) or
``RGB`` (its ``LipshitzMLP`` waits for ROADMAP.md Queue 1 item 5, part 2).
The background is a constant colour, or with ``bg_color`` None (the
default) or "trained" the ``NerfHash`` field over the contracted space
(``methods/base.py::render_contracted_bg``, which JAX keeps here: kernel
K10's samples, jittered by a draw of ``_uniform`` in training, after the
samplers'). The sphere-traced render
(``render_rays_sphere_traced``, ``make_render_fn(sphere_traced=True)``)
marches the SDF with kernel K9 and shades once at the hits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from volsurfs_tpu_torch.methods.base import (grad_norms, make_background, make_optimizer,
                                             render_background)
from volsurfs_tpu_torch.methods.volsurfs import resolve_device
from volsurfs_tpu_torch.models.field_utils import get_field_gradients, get_sdf_curvature
from volsurfs_tpu_torch.models.fields import RGB, SDF, ColorSH
from volsurfs_tpu_torch.ops import raycast as RC
from volsurfs_tpu_torch.ops import samplers as SP
from volsurfs_tpu_torch.ops import volume_rendering as VR
from volsurfs_tpu_torch.ops.occupancy import make_grid
from volsurfs_tpu_torch.ops.sphere_tracing import sphere_trace
from volsurfs_tpu_torch.utils import losses as L
from volsurfs_tpu_torch.utils.math import safe_norm, safe_normalize
from volsurfs_tpu_torch.utils.schedules import get_logistic_beta_from_variance, map_range_val

class Surf:
    method_name = "surf"
    nr_sphere_init_points = 30000  # random points a sphere-init step

    def __init__(
        self,
        hyper_params,
        bounding_primitive,
        bg_color: Optional[str] = None,
        init_sphere_radius: float = 0.3,
        occupancy_res: int = 256,
        device="cuda",
        seed: int = 0,
    ):
        self.device = resolve_device(device)
        self.hp = hp = hyper_params
        self.bounding_primitive = bounding_primitive
        self.init_sphere_radius = init_sphere_radius
        self.occupancy_res = occupancy_res
        self.radius = radius = float(bounding_primitive.get_radius())

        generator = torch.Generator().manual_seed(seed)
        sdf = SDF(mlp_layers_dims=tuple(hp.sdf_mlp_layers_dims),
                  encoding_type=hp.sdf_encoding_type, geom_feat_size=hp.geom_feat_size,
                  nr_iters_for_c2f=hp.sdf_nr_iters_for_c2f, bb_sides=radius * 2.0,
                  generator=generator)
        colour = dict(mlp_layers_dims=tuple(hp.rgb_mlp_layers_dims),
                      pos_encoder_type=hp.rgb_pos_encoder_type, sh_deg=hp.sh_degree,
                      normal_dep=hp.rgb_normal_dep, geom_feat_dep=hp.rgb_geom_feat_dep,
                      in_geom_feat_size=hp.geom_feat_size,
                      nr_iters_for_c2f=hp.rgb_nr_iters_for_c2f, bb_sides=radius * 2.0,
                      mlp_dtype="bfloat16" if hp.use_grad_scaler else None,
                      generator=generator)
        if hp.appearance_predict_sh_coeffs:
            rgb = ColorSH(**colour)
        else:
            rgb = RGB(view_dep=hp.rgb_view_dep, use_lipshitz_mlp=hp.rgb_use_lipshitz_mlp,
                      **colour)
        self.bg_color, bg = make_background(bg_color, hp, self.device, generator)
        models = {"sdf": sdf, "rgb": rgb}
        if bg is not None:
            models["bg"] = bg
        self.models = nn.ModuleDict(models).to(self.device)
        self.optimizer, self.scheduler = make_optimizer(
            hp, self.models.parameters(), warmup_start_iter=hp.init_phase_end_iter)
        self.grid = None
        if hp.use_occupancy_grid:
            self.grid = make_grid(occupancy_res, radius * 2.0, sphere_roi_radius=radius,
                                  device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.iter_nr = 0

    # ---- random draws and schedules -----------------------------------------

    def _uniform(self, shape, low: float = 0.0, high: float = 1.0):
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return u if (low, high) == (0.0, 1.0) else u * (high - low) + low

    def _normal(self, shape):
        return torch.randn(shape, generator=self.generator, device=self.device)

    def _variance(self, iter_nr):
        hp = self.hp
        return map_range_val(iter_nr, hp.init_phase_end_iter, hp.first_phase_end_iter,
                             hp.first_phase_variance_start_value,
                             hp.first_phase_variance_end_value)

    def _cos_anneal(self, iter_nr):
        return map_range_val(iter_nr, self.hp.init_phase_end_iter, self.hp.first_phase_end_iter,
                             0.0, 1.0)

    def _beta(self, iter_nr) -> float:
        return float(get_logistic_beta_from_variance(self._variance(iter_nr)))

    # ---- fields ---------------------------------------------------------------

    def _sdf(self, points, iter_nr):
        return self.models["sdf"](points, iter_nr)

    def _sdf_with_grad(self, points, iter_nr):
        """(sdf, geom_feat, sdf_grad): the encoder's analytic Jacobian
        (sdf_grads_mode "autodiff") or 4-point forward differences."""
        if self.hp.sdf_grads_mode == "autodiff":
            return self.models["sdf"](points, iter_nr, with_grads=True)
        sdf, geom_feat = self._sdf(points, iter_nr)
        grad = get_field_gradients(lambda p: self._sdf(p, iter_nr), points)
        return sdf, geom_feat, grad

    # ---- sampling ---------------------------------------------------------------

    def _sample_rays(self, rays_o, rays_d, t_near, t_far, iter_nr, jitter: bool):
        """Samples in the occupied space (or the whole interval without a
        grid), then two rounds of importance sampling on the SDF, without
        gradients."""
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

        n_imp = hp.max_nr_imp_samples_per_ray

        def imp_jitter():
            return self._uniform((R, n_imp // 2), -0.5, 0.5) if jitter else None

        return SP.importance_refine(uniform, lambda s: self._sdf(s.positions(), iter_nr)[0],
                                    self._beta(iter_nr), n_imp, hp.min_dist_between_samples,
                                    imp_jitter)

    # ---- rendering ------------------------------------------------------------

    def render_rays(self, rays_o, rays_d, iter_nr=None, train: bool = False) -> dict:
        """Volumetric render of rays [R, 3]; differentiable w.r.t. both
        fields' parameters. train jitters the samples."""
        iter_nr = self.iter_nr if iter_nr is None else iter_nr
        raycast = RC.intersect_bounding_primitive(self.bounding_primitive, rays_o, rays_d)
        beta = self._beta(iter_nr)
        cos_anneal = float(self._cos_anneal(iter_nr))
        samples = self._sample_rays(rays_o, rays_d, raycast["t_near"], raycast["t_far"],
                                    iter_nr, jitter=train)

        pos = samples.positions()
        sdf, geom_feat, sdf_grad = self._sdf_with_grad(pos, iter_nr)
        normals = safe_normalize(sdf_grad)
        rgb_samples = self.models["rgb"](pos, samples.dirs(), normals, geom_feat, iter_nr)
        alpha = VR.neus_alpha_from_sdf_gradients(samples, sdf, sdf_grad, cos_anneal, beta)
        weights, _, _ = VR.neus_weights(samples, alpha)
        weights_sum, _ = VR.sum_over_rays(weights, samples.mask)
        bg_transmittance = 1.0 - weights_sum
        rgb_fg = VR.integrate(rgb_samples, weights, samples.mask)
        depth_fg = VR.integrate(samples.z[..., None], weights, samples.mask)
        pred_normals = VR.integrate(normals, weights, samples.mask)

        rgb_bg, depth_bg = render_background(self, raycast, rays_o.shape[0], iter_nr, train)
        return {
            "rgb": rgb_fg + rgb_bg * bg_transmittance,
            "rgb_fg": rgb_fg,
            "rgb_bg": rgb_bg,
            "depth": depth_fg * weights_sum + depth_bg * bg_transmittance,
            "depth_fg": depth_fg,
            "weights_sum": weights_sum,
            "bg_transmittance": bg_transmittance,
            "normals": pred_normals,
            "nr_samples": samples.samples_per_ray(),
            "samples": samples,
            "samples_sdf_grad": sdf_grad,
        }

    # ---- losses ----------------------------------------------------------------

    def _data_loss(self, batch, iter_nr):
        hp = self.hp
        res = self.render_rays(batch["rays_o"], batch["rays_d"], iter_nr, train=True)
        pred_rgb = res["rgb"]
        if hp.nr_training_rays_per_pixel > 1:
            pred_rgb = pred_rgb.reshape(-1, hp.nr_training_rays_per_pixel, 3).mean(1)
        mask = batch["gt_mask"] if hp.is_training_masked else None
        loss_rgb = L.loss_l1(batch["gt_rgb"], pred_rgb, mask=mask)
        loss = loss_rgb

        r_points = self.bounding_primitive.get_random_points_inside(self.generator, 1024)
        r_sdf, _, r_grad = self._sdf_with_grad(r_points, iter_nr)
        samples = res["samples"]
        s_mask, s_grad = samples.mask, res["samples_sdf_grad"]
        denom = torch.clamp(torch.sum(s_mask), min=1)
        zero = torch.zeros((), device=self.device)

        loss_eik = zero
        if hp.eikonal_weight > 0.0:
            err = torch.where(s_mask, (safe_norm(s_grad, dim=-1) - 1.0) ** 2, 0.0)
            loss_eik = (L.eikonal_loss(r_grad) * hp.eikonal_weight
                        + (torch.sum(err) / denom) * hp.eikonal_weight)
            loss = loss + loss_eik

        loss_offsurface = zero
        if hp.offsurface_weight > 0.0:
            loss_offsurface = L.offsurface_loss(r_sdf) * hp.offsurface_weight
            loss = loss + loss_offsurface

        loss_curv = zero
        if hp.curvature_weight > 0.0:
            gw = 1.0
            if hp.reduce_curv_start_iter is not None and hp.reduce_curv_end_iter is not None:
                gw = float(map_range_val(iter_nr, hp.reduce_curv_start_iter,
                                         hp.reduce_curv_end_iter, 1.0, 0.0))
            pos = samples.positions()
            curv = get_sdf_curvature(
                lambda p: self._sdf(p, iter_nr), pos, s_grad, self._normal(pos.shape),
                grad_fn=lambda p: self._sdf_with_grad(p, iter_nr)[2])
            curv = torch.where(s_mask[..., None], curv, 0.0)
            loss_curv = (torch.sum(curv) / denom) * hp.curvature_weight * gw
            loss = loss + loss_curv

        losses = {
            "loss": loss,
            "rgb": loss_rgb,
            "eikonal": loss_eik,
            "curvature": loss_curv,
            "offsurface_high_sdf": loss_offsurface,
            "lipshitz": zero,
            "nr_samples_total": torch.sum(res["nr_samples"]),
        }
        return loss, losses

    def _sphere_init_loss(self, iter_nr):
        """Fit the SDF to a sphere of init_sphere_radius at
        nr_sphere_init_points random points, with a small eikonal term."""
        points = self.bounding_primitive.get_random_points_inside(
            self.generator, self.nr_sphere_init_points)
        sdf_gt = torch.linalg.norm(points, dim=-1, keepdim=True) - self.init_sphere_radius
        sdf_pred, _, grad = self._sdf_with_grad(points, iter_nr)
        loss_sdf = torch.mean((sdf_pred - sdf_gt) ** 2)
        loss_eik = torch.mean((safe_norm(grad, dim=-1) - 1.0) ** 2)
        loss = loss_sdf + loss_eik * 1e-3
        return loss, {"loss": loss, "sdf": loss_sdf, "eikonal": loss_eik}

    def train_step(self, batch) -> dict:
        """One Adam step: the sphere-init loss before init_phase_end_iter
        (the batch unused), the data loss after. Returns the losses and the
        gradient norms as 0-d tensors (no host sync)."""
        it = self.iter_nr
        self.optimizer.zero_grad(set_to_none=True)
        if it < self.hp.init_phase_end_iter:
            loss, losses = self._sphere_init_loss(it)
        else:
            loss, losses = self._data_loss(batch, it)
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
        """Re-evaluate |sdf| at the voxel centres (65,536 a chunk) and refresh
        the occupancy from the logistic density of the variance (at most
        0.8)."""
        if self.grid is None:
            return
        grid = self.grid
        n = grid.res ** 3
        chunk = min(n, 65536)
        with torch.no_grad():
            sdf_abs = torch.cat([
                torch.abs(self._sdf(grid.voxel_centers(s, min(s + chunk, n)),
                                    self.iter_nr)[0][..., 0])
                for s in range(0, n, chunk)])
        variance = np.minimum(np.float32(0.8), self._variance(self.iter_nr))
        beta = float(get_logistic_beta_from_variance(variance))
        grid = grid.update_values(sdf_abs, decay=0.0)
        self.grid = grid.update_occupancy_with_sdf(beta, occupancy_thresh=1e-4)

    def render_rays_sphere_traced(self, rays_o, rays_d, iter_nr=None, max_st_steps: int = 24,
                                  converged_dist_tresh: float = 1e-3,
                                  min_step: float = 8e-3) -> dict:
        """Test-time surface render: sphere trace the SDF (lockstep, kernel
        K9 a step; grid-assisted with the occupancy grid), shade once at
        the hits, and take the background (unjittered) elsewhere. Without
        autograd. ``self.last_trace_steps`` keeps the trace's steps."""
        iter_nr = self.iter_nr if iter_nr is None else iter_nr
        with torch.no_grad():
            raycast = RC.intersect_bounding_primitive(self.bounding_primitive, rays_o, rays_d)
            trace = sphere_trace(lambda p: self._sdf(p, iter_nr), rays_o, rays_d,
                                 self.bounding_primitive, nr_sphere_traces=max_st_steps,
                                 sdf_converged_tresh=converged_dist_tresh,
                                 occupancy_grid=self.grid, min_step=min_step)
            self.last_trace_steps = trace["steps"]
            hit = trace["is_hit"][:, None]
            pos = trace["positions"]
            _, geom_feat, grad = self._sdf_with_grad(pos, iter_nr)
            normals = safe_normalize(grad)
            rgb_surf = self.models["rgb"](pos, rays_d, normals, geom_feat, iter_nr)
            weights_sum = hit.float()
            rgb_bg, depth_bg = render_background(self, raycast, rays_o.shape[0], iter_nr,
                                                 train=False)
        return {
            "rgb": torch.where(hit, rgb_surf, rgb_bg),
            "rgb_fg": torch.where(hit, rgb_surf, 0.0),
            "depth": torch.where(hit, trace["z"], depth_bg),
            "normals": torch.where(hit, normals, 0.0),
            "weights_sum": weights_sum,
            "bg_transmittance": 1.0 - weights_sum,
        }

    def make_render_fn(self, sphere_traced: bool = False):
        """fn(rays_o, rays_d) -> {"rgb", "depth", "normals", "weights_sum"}
        at the method's iter_nr, without autograd: the volumetric render, or
        with sphere_traced the sphere-traced one."""

        def render(rays_o, rays_d):
            if sphere_traced:
                res = self.render_rays_sphere_traced(rays_o, rays_d, self.iter_nr)
            else:
                with torch.no_grad():
                    res = self.render_rays(rays_o, rays_d, self.iter_nr, train=False)
            return {k: res[k] for k in ("rgb", "depth", "normals", "weights_sum")}

        return render
