"""``volsurfs`` method: appearance training on k extracted mesh shells.

Counterpart of volsurfs_tpu/methods/volsurfs.py for the neural-texture
branch. Every ray is traced against all k shells (ordered inner -> outer)
in one ``trace_all`` (kernel K2 on the card); hit barycentrics give UVs;
per-shell SH neural textures give rgb and alpha, whose hash-table
gradients go through kernel K1; the shells are composited outer -> inner
in float16. The background is a constant colour, or with ``bg_color`` None
(the default) or "trained" the ``NerfHash`` field over the contracted space
(``render_contracted_bg``: kernel K10's samples behind the bounding
primitive, jittered in training by a draw of ``self.generator``), which
enters the float16 composite as JAX's does.

Parameters keep the JAX names: ``rgb_{i}`` and ``alpha_{i}`` are the
per-shell ``SHNeuralTextures`` (one shared ``rgb_0`` / ``alpha_0`` when
colors or alphas are not independent); ``bg`` is the background's field.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from volsurfs_tpu_torch.methods.base import make_background, make_optimizer, render_background
from volsurfs_tpu_torch.models.textures import SHNeuralTextures
from volsurfs_tpu_torch.ops import bvh as B
from volsurfs_tpu_torch.ops import raycast as RC
from volsurfs_tpu_torch.utils import losses as L
from volsurfs_tpu_torch.utils.math import small_cumprod, take_rev


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA device on a host without CUDA raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return device


class VolSurfs:
    method_name = "volsurfs"

    def __init__(
        self,
        hyper_params,
        meshes: Sequence[tuple],  # [(verts, faces, uvs), ...] inner -> outer
        bg_color: Optional[str] = None,
        bounding_primitive=None,
        device="cuda",
        seed: int = 0,
    ):
        self.device = resolve_device(device)
        self.hp = hp = hyper_params
        self.nr_meshes = len(meshes)
        if self.nr_meshes < 1:
            raise ValueError("volsurfs needs at least one mesh")
        if not hp.using_neural_textures:
            raise NotImplementedError("only the neural-texture branch is ported; the legacy "
                                      "appearance waits for ROADMAP.md Queue 1 item 5, part 2")
        self.bounding_primitive = bounding_primitive or RC.make_bounding_sphere(1.0)

        self.tensor_meshes = [
            B.make_tensor_mesh(v, f, uv, device=self.device) for (v, f, uv) in meshes
        ]
        self.stacked_bvh = B.stack_bvhs(
            [B.build_bvh(v, f) for (v, f, uv) in meshes], self.device
        )

        self.nr_rgb_models = self.nr_meshes if hp.are_volsurfs_colors_indep else 1
        self.nr_alpha_models = self.nr_meshes if hp.are_volsurfs_alphas_indep else 1
        # innermost mesh can be solid: no alpha model for mesh 0
        self.solid_inner = hp.is_inner_mesh_solid

        generator = torch.Generator().manual_seed(seed)
        mlp_dtype = "bfloat16" if hp.use_grad_scaler else None

        def textures(nr_channels):
            return SHNeuralTextures(
                sh_deg=hp.sh_degree,
                nr_channels=nr_channels,
                sh_range=tuple(hp.sh_range),
                deg_res=tuple(hp.textures_res),
                anchor=hp.using_neural_textures_anchor,
                lerp=hp.using_neural_textures_lerp,
                quantize_output=hp.using_sh_quantization,
                squeeze_output=hp.using_sh_squeezing,
                mlp_dtype=mlp_dtype,
                generator=generator,
            )

        models = {f"rgb_{i}": textures(3) for i in range(self.nr_rgb_models)}
        models.update({f"alpha_{i}": textures(1) for i in range(self.nr_alpha_models)})
        self.bg_color, bg = make_background(bg_color, hp, self.device, generator)
        if bg is not None:
            models["bg"] = bg
        self.models = nn.ModuleDict(models).to(self.device)
        self.optimizer, self.scheduler = make_optimizer(
            hp, self.models.parameters(), warmup_start_iter=0
        )
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.iter_nr = 0

    def _uniform(self, shape):
        return torch.rand(shape, generator=self.generator, device=self.device)

    # ---- rendering ---------------------------------------------------------

    def _rgb_model(self, i):
        return self.models[f"rgb_{i if self.hp.are_volsurfs_colors_indep else 0}"]

    def _alpha_model(self, i):
        return self.models[f"alpha_{i if self.hp.are_volsurfs_alphas_indep else 0}"]

    def render_rays(self, rays_o, rays_d, iter_nr=None, train: bool = False) -> dict:
        """Render rays [R, 3] through all shells; differentiable w.r.t. the
        texture (and background) parameters. train jitters the
        background's samples; iter_nr (the method's by default) sets the
        background's coarse-to-fine window."""
        hp = self.hp
        R = rays_o.shape[0]
        iter_nr = self.iter_nr if iter_nr is None else iter_nr
        hits_all = B.trace_all(self.stacked_bvh, rays_o, rays_d)

        surfs_rgb, surfs_alpha, surfs_hits = [], [], []
        surfs_normals, surfs_depths, surfs_uvs = [], [], []
        for i, mesh in enumerate(self.tensor_meshes):
            is_hit = hits_all["is_hit"][i]
            tri, bary = hits_all["triangles_id"][i], hits_all["barycentric"][i]
            uv = mesh.face_attr(mesh.uvs, tri, bary)
            normals = mesh.face_attr(mesh.normals, tri, bary)
            normals = normals / torch.clamp(
                torch.linalg.norm(normals, dim=-1, keepdim=True), min=1e-12
            )

            rgb = self._rgb_model(i)(uv, rays_d)
            if self.solid_inner and i == 0:
                alpha = torch.ones(R, 1, device=rays_o.device)
            else:
                alpha = self._alpha_model(i)(uv, rays_d)
                if hp.with_alpha_decay:
                    # grazing-angle transparency decay, threshold 10
                    dot = torch.clamp(
                        torch.sum(-rays_d * normals, dim=-1, keepdim=True), 0.0, 1.0
                    )
                    decay = torch.sigmoid(10.0 * dot) * 2.0 - 1.0
                    alpha = alpha * decay.detach()

            m = is_hit[:, None]
            surfs_rgb.append(torch.where(m, rgb, 0.0))
            surfs_alpha.append(torch.where(m, alpha, 0.0))
            surfs_hits.append(is_hit)
            surfs_normals.append(torch.where(m, normals, 0.0))
            surfs_depths.append(torch.where(m, hits_all["depth"][i], 0.0))
            surfs_uvs.append(torch.where(m, uv, 0.0))

        surfs_rgb = torch.stack(surfs_rgb, dim=1)  # [R, k, 3] inner -> outer
        surfs_alpha = torch.stack(surfs_alpha, dim=1)  # [R, k, 1]

        # float16 compositing outer -> inner
        rgb_o2i = take_rev(surfs_rgb, dim=1).half()
        alpha_o2i = take_rev(surfs_alpha, dim=1).half()
        transmittances = small_cumprod(1.0 - alpha_o2i, dim=1)
        surfs_T = torch.cat(
            [torch.ones_like(transmittances[:, :1]), transmittances[:, :-1]], dim=1
        )
        bg_transmittance = transmittances[:, -1]
        blending = surfs_T * alpha_o2i
        rgb_fg = torch.sum(rgb_o2i * blending, dim=1)

        if "bg" in self.models:
            raycast = RC.intersect_bounding_primitive(self.bounding_primitive, rays_o, rays_d)
            rgb_bg, _ = render_background(self, raycast, R, iter_nr, train)
        else:
            rgb_bg = self.bg_color.expand(R, 3)
        rgb = (rgb_fg + bg_transmittance * rgb_bg.half()).float()
        return {
            "rgb": rgb,
            "rgb_fg": rgb_fg.float(),
            "rgb_bg": rgb_bg,
            "bg_transmittance": bg_transmittance.float(),
            "surfs_rgb": surfs_rgb,
            "surfs_alpha": surfs_alpha,
            "surfs_hits": torch.stack(surfs_hits, dim=1),
            "surfs_normals": torch.stack(surfs_normals, dim=1),
            "surfs_depths": torch.stack(surfs_depths, dim=1),
            "surfs_uvs": torch.stack(surfs_uvs, dim=1),
            "surfs_blending_weights": take_rev(blending, dim=1).float(),
        }

    # ---- loss and steps ------------------------------------------------------

    def _loss(self, batch):
        hp = self.hp
        pred_rgb = self.render_rays(batch["rays_o"], batch["rays_d"], train=True)["rgb"]
        if hp.nr_training_rays_per_pixel > 1:
            pred_rgb = pred_rgb.reshape(-1, hp.nr_training_rays_per_pixel, 3).mean(1)
        if hp.is_training_masked:
            return L.loss_l1(batch["gt_rgb"], pred_rgb, mask=batch["gt_mask"])
        return L.loss_l1(batch["gt_rgb"], pred_rgb)

    def train_step(self, batch) -> dict:
        """One Adam step on a ray batch (rays_o, rays_d, gt_rgb[, gt_mask]).
        Returns {"loss", "rgb"} as 0-d tensors (no host sync)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss(batch)
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        self.iter_nr += 1
        loss = loss.detach()
        return {"loss": loss, "rgb": loss}

    def make_render_fn(self):
        """fn(rays_o, rays_d) -> {"rgb", "bg_transmittance"}, without grad."""

        def render(rays_o, rays_d):
            with torch.no_grad():
                res = self.render_rays(rays_o, rays_d)
            return {"rgb": res["rgb"], "bg_transmittance": res["bg_transmittance"]}

        return render
