"""``offsets_surfs`` method: a main SDF and k offset level-set surfaces.
Counterpart of volsurfs_tpu/methods/offsets_surfs.py.

``OffsetsSDF``'s shared encoder predicts the main SDF and, through its eps
heads, the offsets of the other surfaces. All K surfaces are rendered from
one shared sample set: the samples are placed in the occupied space (kernel
K7) and refined by two rounds of importance sampling on the CDF averaged
over the surfaces (kernel K8c, with K8a's merges), without gradients. Each
surface then takes its own NeuS alphas, transmittances (one [K*R, S] scan,
kernel K8b) and integrated rgb and opacity; the surfaces are alpha-blended
outer to inner. The SDF with every surface's analytic gradient is one
lookup of kernel K6 with grads.

The shared colour and transparency fields (``are_surfs_*_indep`` 0, as the
configs set them above one surface; at one surface, base_1.cfg's, the flags
select nothing) look their position encoding up once for all K surfaces
(``RGB.forward_surfaces``), where JAX looks it up K times at the same
points; the table's gradient is then one sum instead of K.

The phases (offsets-init, color-init, first, second) freeze sub-networks
by detaching their outputs where JAX stops their gradients. Every
parameter takes an Adam step every step, with a zero gradient where the
loss does not reach it, as optax does.

Random numbers come from ``self.generator`` in JAX's order, through
``_uniform``, ``_normal`` and the bounding primitive's
``get_random_points_inside``. The background is a constant colour, or
with ``bg_color`` None (the default) or "trained" the ``NerfHash`` field
over the contracted space (``render_contracted_bg``: kernel K10's samples,
jittered by a draw after the samplers' in training), trained in every
phase that renders.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from volsurfs_tpu_torch.methods.base import (grad_norms, make_background, make_optimizer,
                                             render_background)
from volsurfs_tpu_torch.methods.volsurfs import resolve_device
from volsurfs_tpu_torch.models.field_utils import get_fields_gradients, get_sdf_curvature
from volsurfs_tpu_torch.models.fields import RGB, OffsetsSDF
from volsurfs_tpu_torch.ops import raycast as RC
from volsurfs_tpu_torch.ops import samplers as SP
from volsurfs_tpu_torch.ops import volume_rendering as VR
from volsurfs_tpu_torch.ops.occupancy import make_grid
from volsurfs_tpu_torch.utils import losses as L
from volsurfs_tpu_torch.utils.math import safe_norm, safe_normalize, small_cumprod, take_rev
from volsurfs_tpu_torch.utils.schedules import (
    get_logistic_beta_from_variance,
    logistic_distribution_stdev,
    map_range_val,
)

def get_offsets_gt(nr_outer_surfs: int, nr_inner_surfs: int, delta_surfs: float,
                   device=None):
    """Target offsets of the offsets-init phase: +-i*delta ordered [inner
    largest-first..., outer...]."""
    inner = [(i + 1) * delta_surfs for i in range(nr_inner_surfs)]
    outer = [-(i + 1) * delta_surfs for i in range(nr_outer_surfs)]
    return torch.tensor(inner[::-1] + outer, dtype=torch.float32, device=device)


class OffsetsSurfs:
    method_name = "offsets_surfs"
    nr_offsets_init_points = 30000  # random points an offsets-init step

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
        self.nr_inner_surfs, self.nr_outer_surfs = hp.nr_inner_surfs, hp.nr_outer_surfs
        self.nr_surfs = hp.nr_inner_surfs + hp.nr_outer_surfs + 1
        self.main_surf_idx = hp.nr_inner_surfs
        # with one surface the per-surface fields are the shared ones: JAX
        # builds one model of each, rgb_0 and alpha_0, either way (base_1.cfg
        # sets both flags)
        if self.nr_surfs > 1 and (hp.are_surfs_colors_indep or hp.are_surfs_transparency_indep):
            raise NotImplementedError(
                "offsets_surfs: per-surface colour or transparency fields "
                "(are_surfs_*_indep) above one surface are not ported; only "
                "config/offsets_surfs/base_1.cfg sets them, at one surface")

        # the offsets-init targets, from the logistic stdev of the first
        # phase's starting variance
        stdev = float(logistic_distribution_stdev(
            np.clip(np.exp(hp.first_phase_variance_start_value * 10.0), 1e-6, 1e6)))
        self.delta_surfs = stdev * hp.delta_surfs_multiplier
        self.offsets_gt = get_offsets_gt(self.nr_outer_surfs, self.nr_inner_surfs,
                                         self.delta_surfs, self.device)

        generator = torch.Generator().manual_seed(seed)
        sdfs = OffsetsSDF(mlp_layers_dims=tuple(hp.sdf_mlp_layers_dims),
                          encoding_type=hp.sdf_encoding_type,
                          nr_inner_surfs=self.nr_inner_surfs,
                          nr_outer_surfs=self.nr_outer_surfs, geom_feat_size=hp.geom_feat_size,
                          nr_iters_for_c2f=0, bb_sides=radius * 2.0, generator=generator)

        def appearance(out_channels, view_dep, normal_dep, geom_feat_dep):
            return RGB(mlp_layers_dims=tuple(hp.rgb_mlp_layers_dims),
                       pos_encoder_type=hp.rgb_pos_encoder_type, out_channels=out_channels,
                       sh_deg=hp.sh_degree, view_dep=view_dep, normal_dep=normal_dep,
                       geom_feat_dep=geom_feat_dep, in_geom_feat_size=hp.geom_feat_size,
                       nr_iters_for_c2f=hp.rgb_nr_iters_for_c2f, bb_sides=radius * 2.0,
                       mlp_dtype="bfloat16" if hp.use_grad_scaler else None,
                       generator=generator)

        models = {
            "sdfs": sdfs,
            "rgb_0": appearance(3, hp.rgb_view_dep, hp.rgb_normal_dep, hp.rgb_geom_feat_dep),
            "alpha_0": appearance(1, hp.transp_view_dep, hp.transp_normal_dep,
                                  hp.transp_geom_feat_dep),
        }
        self.bg_color, bg = make_background(bg_color, hp, self.device, generator)
        if bg is not None:
            models["bg"] = bg
        self.models = nn.ModuleDict(models).to(self.device)
        self.optimizer, self.scheduler = make_optimizer(
            hp, self.models.parameters(), warmup_start_iter=hp.color_init_phase_end_iter)
        self.grid = None
        if hp.use_occupancy_grid:
            self.grid = make_grid(occupancy_res, radius * 2.0, sphere_roi_radius=radius,
                                  device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.iter_nr = 0

    def load_main_sdf(self, sdf_state: dict):
        """A surf run's ``SDF`` (its state dict: ``encoder`` and ``mlp``)
        into the shared encoder and the main head."""
        sdfs = self.models["sdfs"]
        with torch.no_grad():
            for prefix, module in (("encoder.", sdfs.pos_encoder), ("mlp.", sdfs.mlp_sdf)):
                module.load_state_dict({k[len(prefix):]: v for k, v in sdf_state.items()
                                        if k.startswith(prefix)})
        return self

    # ---- random draws, phases and schedules -----------------------------------

    def _uniform(self, shape, low: float = 0.0, high: float = 1.0):
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return u if (low, high) == (0.0, 1.0) else u * (high - low) + low

    def _normal(self, shape):
        return torch.randn(shape, generator=self.generator, device=self.device)

    def phase(self, it: int) -> str:
        hp = self.hp
        if it < hp.init_phase_end_iter:
            return "offsets_init"
        if it < hp.color_init_phase_end_iter:
            return "color_init"
        if it < hp.first_phase_end_iter:
            return "first"
        return "second"

    def _variance(self, iter_nr):
        hp = self.hp
        return map_range_val(iter_nr, hp.color_init_phase_end_iter, hp.first_phase_end_iter,
                             hp.first_phase_variance_start_value,
                             hp.first_phase_variance_end_value)

    def _alpha_decay_factor(self, iter_nr):
        """1000 during the init phases, annealed to 10 over the first."""
        return map_range_val(iter_nr, self.hp.color_init_phase_end_iter,
                             self.hp.first_phase_end_iter, 1000.0, 10.0)

    def _beta(self, iter_nr) -> float:
        return float(get_logistic_beta_from_variance(self._variance(iter_nr)))

    # ---- fields ---------------------------------------------------------------

    def _sdfs(self, points, iter_nr, train_main=True, train_offsets=True):
        return self.models["sdfs"](points, iter_nr, train_main, train_offsets)

    def _sdfs_with_grads(self, points, iter_nr, train_main=True, train_offsets=True):
        """(sdfs, offsets, geom_feat, sdfs_grad [..., K, 3]): every surface's
        analytic gradient (sdf_grads_mode "autodiff") or 4-point forward
        differences."""
        if self.hp.sdf_grads_mode == "autodiff":
            return self.models["sdfs"](points, iter_nr, train_main, train_offsets,
                                       with_grads=True)
        sdfs, offsets, geom_feat = self._sdfs(points, iter_nr, train_main, train_offsets)
        grads = get_fields_gradients(
            lambda p: self._sdfs(p, iter_nr, train_main, train_offsets)[0][..., 0], points)
        return sdfs, offsets, geom_feat, grads

    # ---- sampling ---------------------------------------------------------------

    def _sample_rays(self, rays_o, rays_d, t_near, t_far, iter_nr, jitter: bool,
                     train_main=True, train_offsets=True):
        """Samples in the occupied space (or the whole interval without a
        grid), then two rounds of importance sampling on the CDF averaged
        over the surfaces, without gradients."""
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

        def sdfs_at(samples):  # [R, S, K]
            return self._sdfs(samples.positions(), iter_nr, train_main, train_offsets)[0][..., 0]

        return SP.importance_refine(uniform, sdfs_at, self._beta(iter_nr), n_imp,
                                    hp.min_dist_between_samples, imp_jitter)

    # ---- rendering ------------------------------------------------------------

    def render_rays(self, rays_o, rays_d, iter_nr=None, train: bool = False,
                    train_main: bool = True, train_offsets: bool = True) -> dict:
        """Volumetric render of every surface along rays [R, 3] and their
        blend outer to inner; differentiable in the parameters. train
        jitters the samples."""
        hp = self.hp
        iter_nr = self.iter_nr if iter_nr is None else iter_nr
        raycast = RC.intersect_bounding_primitive(self.bounding_primitive, rays_o, rays_d)
        beta = self._beta(iter_nr)
        decay_factor = float(self._alpha_decay_factor(iter_nr))
        samples = self._sample_rays(rays_o, rays_d, raycast["t_near"], raycast["t_far"],
                                    iter_nr, train, train_main, train_offsets)
        pos, dirs = samples.positions(), samples.dirs()
        K = self.nr_surfs
        R, S_ = samples.mask.shape

        # every surface's value and gradient from one evaluation
        sdfs, _, geom_feat, surfs_grad = self._sdfs_with_grads(pos, iter_nr, train_main,
                                                               train_offsets)
        normals = torch.movedim(safe_normalize(surfs_grad), -2, 0)  # [K, R, S, 3]
        rgb = self.models["rgb_0"].forward_surfaces(pos, dirs, normals, geom_feat, iter_nr)
        transparency = self.models["alpha_0"].forward_surfaces(pos, dirs, normals, geom_feat,
                                                               iter_nr)
        if hp.with_alpha_decay:
            # the transparency fades at grazing angles (the decay carries no
            # gradient)
            with torch.no_grad():
                dot = torch.clamp(torch.sum(-dirs * normals, dim=-1, keepdim=True), 0.0, 1.0)
                decay = torch.sigmoid(decay_factor * dot) * 2.0 - 1.0
            transparency = transparency * decay
        # the NeuS alphas of all surfaces ([K, R, S]; cos_anneal stays 1) and
        # one transmittance scan over their [K*R, S] rows
        alpha = VR.neus_alpha_from_sdf_gradients(
            samples, torch.movedim(sdfs[..., 0], -1, 0), torch.movedim(surfs_grad, -2, 0), 1.0,
            beta)
        mask_all = samples.mask.repeat(K, 1)
        w_all, _, _ = VR.neus_transmittance(alpha.reshape(K * R, S_), mask_all)

        def integrate(values):  # [K, R, S, C] -> [K, R, C]
            out = VR.integrate(values.reshape(K * R, S_, -1), w_all, mask_all)
            return out.reshape(K, R, -1)

        surfs_rgb = torch.movedim(integrate(rgb), 0, 1)  # [R, K, 3] inner..outer
        surfs_alpha = torch.movedim(integrate(transparency), 0, 1)  # [R, K, 1]
        with torch.no_grad():
            surfs_normals = torch.movedim(integrate(normals), 0, 1)
            surfs_depths = torch.movedim(integrate(samples.z[None, ..., None].expand(K, R, S_, 1)),
                                         0, 1)
            surfs_weight_sum = torch.movedim(
                VR.sum_over_rays(w_all, mask_all)[0].reshape(K, R, 1), 0, 1)

        # blend outer -> inner: T_k = cumprod(1 - alpha) in the flipped order
        rgb_o2i = take_rev(surfs_rgb, 1)
        alpha_o2i = take_rev(surfs_alpha, 1)
        transmittances = small_cumprod(1.0 - alpha_o2i, 1)
        if K == 1:
            surfs_T = torch.ones_like(transmittances)
        else:
            surfs_T = torch.cat([torch.ones_like(transmittances[:, :1]),
                                 transmittances[:, :-1]], dim=1)
        bg_transmittance = transmittances[:, -1]
        blending_weights = surfs_T * alpha_o2i
        rgb_fg = torch.sum(rgb_o2i * blending_weights, dim=1)
        rgb_bg, _ = render_background(self, raycast, R, iter_nr, train)
        return {
            "rgb": rgb_fg + rgb_bg * bg_transmittance,
            "rgb_fg": rgb_fg,
            "rgb_bg": rgb_bg,
            "bg_transmittance": bg_transmittance,
            "surfs_rgb": surfs_rgb,
            "surfs_alpha": surfs_alpha,
            "surfs_normals": surfs_normals,
            "surfs_depths": surfs_depths,
            "surfs_weight_sum": surfs_weight_sum,
            "surfs_blending_weights": take_rev(blending_weights, 1),
            "nr_samples": samples.samples_per_ray(),
            "samples": samples,
            "samples_sdfs": sdfs,
            "samples_sdfs_grad": surfs_grad,
        }

    # ---- losses ----------------------------------------------------------------

    def _support_idx(self):
        return [i for i in range(self.nr_surfs) if i != self.main_surf_idx]

    def _support_grads(self, pts, iter_nr, train_main, train_offsets):
        grads = self._sdfs_with_grads(pts, iter_nr, train_main, train_offsets)[3]
        return grads[:, self._support_idx(), :]

    def _offsets_init_loss(self, iter_nr):
        """Fit the offsets to offsets_gt at random points (the main surface
        frozen), with the support surfaces' eikonal term."""
        hp = self.hp
        if self.nr_surfs == 1:
            # no offset to fit (base_1.cfg): the loss is 0, its gradient 0
            # (JAX's concatenation of no eps head raises here)
            zero = 0.0 * next(self.models["sdfs"].parameters()).sum()
            return zero, {"loss": zero, "offsets": zero.detach(), "eikonal_supp": zero.detach()}
        sdfs = self.models["sdfs"]
        pts = self.bounding_primitive.get_random_points_inside(self.generator,
                                                               self.nr_offsets_init_points)
        _, geom_feats = sdfs.main_sdf(pts, iter_nr, False)
        cum_inner, cum_outer, _, _ = sdfs.get_offsets(geom_feats.detach())
        points_offsets = torch.cat([cum_inner, cum_outer], dim=-1)
        loss_offsets = torch.mean(torch.abs(points_offsets - self.offsets_gt[None]))
        loss = loss_offsets
        loss_eik_supp = torch.zeros((), device=self.device)
        if hp.support_surfs_eikonal_weight > 0.0 and self.nr_surfs > 1:
            grads = self._support_grads(pts, iter_nr, False, True)
            loss_eik_supp = L.eikonal_loss(grads) * hp.support_surfs_eikonal_weight
            loss = loss + loss_eik_supp
        return loss, {"loss": loss, "offsets": loss_offsets, "eikonal_supp": loss_eik_supp}

    def _data_loss(self, batch, iter_nr, train_main, train_offsets):
        hp = self.hp
        main = self.main_surf_idx
        res = self.render_rays(batch["rays_o"], batch["rays_d"], iter_nr, True, train_main,
                               train_offsets)
        pred_rgb = res["rgb"]
        if hp.nr_training_rays_per_pixel > 1:
            pred_rgb = pred_rgb.reshape(-1, hp.nr_training_rays_per_pixel, 3).mean(1)
        mask = batch["gt_mask"] if hp.is_training_masked else None
        loss_rgb = L.loss_l1(batch["gt_rgb"], pred_rgb, mask=mask)
        loss = loss_rgb

        samples = res["samples"]
        s_mask, s_grads = samples.mask, res["samples_sdfs_grad"]
        denom = torch.clamp(torch.sum(s_mask), min=1)
        zero = torch.zeros((), device=self.device)

        r_pts = self.bounding_primitive.get_random_points_inside(self.generator, 1024)
        r_sdfs, _, _, r_grads = self._sdfs_with_grads(r_pts, iter_nr, train_main, train_offsets)

        loss_eik_main = zero
        if hp.eikonal_weight > 0.0 and train_main:
            err = torch.where(s_mask, (safe_norm(s_grads[..., main, :], dim=-1) - 1.0) ** 2, 0.0)
            loss_eik_main = (L.eikonal_loss(r_grads[..., main, :]) * hp.eikonal_weight
                             + (torch.sum(err) / denom) * hp.eikonal_weight)
            loss = loss + loss_eik_main

        loss_eik_supp = zero
        if (hp.eikonal_weight > 0.0 and hp.support_surfs_eikonal_weight > 0.0 and train_offsets
                and self.nr_surfs > 1):
            supp = self._support_idx()
            err = torch.where(s_mask[..., None],
                              (safe_norm(s_grads[..., supp, :], dim=-1) - 1.0) ** 2, 0.0)
            loss_eik_supp = (L.eikonal_loss(r_grads[:, supp, :]) * hp.support_surfs_eikonal_weight
                             + (torch.sum(err) / (denom * len(supp)))
                             * hp.support_surfs_eikonal_weight)
            loss = loss + loss_eik_supp

        loss_offsurface = zero
        if hp.offsurface_weight > 0.0:  # the main surface only
            loss_offsurface = L.offsurface_loss(r_sdfs[..., main, 0]) * hp.offsurface_weight
            loss = loss + loss_offsurface

        loss_curv = zero
        if hp.curvature_weight > 0.0 and train_main:
            sdfs_model = self.models["sdfs"]
            grad_fn = None
            if hp.sdf_grads_mode == "autodiff":
                grad_fn = lambda p: sdfs_model.main_sdf_grad(p, iter_nr, train_main)  # noqa: E731
            pos = samples.positions()
            curv = get_sdf_curvature(
                lambda p: self._sdfs(p, iter_nr, train_main, train_offsets)[0][..., main, 0:1],
                pos, s_grads[..., main, :], self._normal(pos.shape), grad_fn=grad_fn)
            curv = torch.where(s_mask[..., None], curv, 0.0)
            loss_curv = (torch.sum(curv) / denom) * hp.curvature_weight
            loss = loss + loss_curv

        losses = {
            "loss": loss,
            "rgb": loss_rgb,
            "eikonal_main": loss_eik_main,
            "eikonal_supp": loss_eik_supp,
            "loss_offsurface_high_sdf": loss_offsurface,
            "curvature": loss_curv,
            "nr_samples_total": torch.sum(res["nr_samples"]),
        }
        return loss, losses

    def _loss(self, batch, iter_nr):
        """The loss of iter_nr's phase: the offsets fit, or the data loss
        with the main surface frozen in the init phases and the offsets
        frozen in color-init."""
        phase = self.phase(iter_nr)
        if phase == "offsets_init":
            return self._offsets_init_loss(iter_nr)
        return self._data_loss(batch, iter_nr, train_main=phase in ("first", "second"),
                               train_offsets=phase != "color_init")

    def train_step(self, batch) -> dict:
        """One Adam step of the current phase's loss (the batch unused in
        offsets-init). Returns the losses and the gradient norms as 0-d
        tensors (no host sync)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, losses = self._loss(batch, self.iter_nr)
        loss.backward()
        # a parameter the loss does not reach (a frozen one included) takes a
        # zero gradient, so that Adam's moments and step count advance for
        # every parameter, as optax's do
        for p in self.models.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        losses.update(grad_norms(self.models))
        self.optimizer.step()
        self.scheduler.step()
        self.iter_nr += 1
        return {k: v.detach() for k, v in losses.items()}

    def update_occupancy_grid(self):
        """Re-evaluate the smallest |sdf| over the surfaces at the voxel
        centres (65,536 a chunk) and refresh the occupancy from the logistic
        density of the variance (at most 0.8)."""
        if self.grid is None:
            return
        grid = self.grid
        n = grid.res ** 3
        chunk = min(n, 65536)
        with torch.no_grad():
            vals = torch.cat([
                torch.amin(torch.abs(self._sdfs(grid.voxel_centers(s, min(s + chunk, n)),
                                                self.iter_nr)[0][..., 0]), dim=-1)
                for s in range(0, n, chunk)])
        variance = np.minimum(np.float32(0.8), self._variance(self.iter_nr))
        beta = float(get_logistic_beta_from_variance(variance))
        grid = grid.update_values(vals, decay=0.0)
        self.grid = grid.update_occupancy_with_sdf(beta, occupancy_thresh=1e-4)

    def make_render_fn(self):
        """fn(rays_o, rays_d) -> {"rgb", "bg_transmittance", "surfs_alpha"
        [n, K]}, the render at the method's iter_nr, without autograd."""

        def render(rays_o, rays_d):
            with torch.no_grad():
                res = self.render_rays(rays_o, rays_d, self.iter_nr, train=False)
            return {"rgb": res["rgb"], "bg_transmittance": res["bg_transmittance"],
                    "surfs_alpha": res["surfs_alpha"][..., 0]}

        return render
