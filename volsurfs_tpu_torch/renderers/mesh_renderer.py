"""Baked-scene renderer: k textured mesh shells, traced and alpha-blended.

Counterpart of volsurfs_tpu/renderers/mesh_renderer.py's
``BakedMeshRenderer``: it loads a baked ``scene.json`` (meshes and SH band
PNGs), finds every ray's closest hit on each shell
(``ops/bvh.trace_all_buffers``, kernel K2), samples the band textures
bilinearly, evaluates the spherical harmonics at the view direction,
applies a sigmoid and composites the shells outer->inner in float16
(``ops/shade.shade_composite_buffers``, kernel K4, which reads K2's
buffers as they are).

Every entry point traces. The JAX package draws camera frames with a
tile-binned rasterizer instead (``renderers/raster.py``), because BVH
traversal is gather-bound on the TPU; its hits equal ``trace_all``'s. Here
``render_frame`` and ``render_frames_device`` trace each camera's rays with
K2 and shade them with K4, so they have no candidate budget that could
overflow, and ``overflow`` stays zero.

The frame entry points (``render_frame``, ``render_frames_device``) cull
back faces, as the JAX frame path does, whenever every camera centre lies
outside every shell's bounding box: there the closest hit on a closed
shell is a front face, so culling drops only the back faces that an open
shell shows through its openings. ``render`` and ``render_rays``, like
JAX's, cull nothing, so on open shells ``render`` and ``render_frame``
differ, as they do in JAX.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from volsurfs_tpu_torch.baking import mesh_io
from volsurfs_tpu_torch.datasets.cameras import get_camera_rays
from volsurfs_tpu_torch.ops import bvh as B
from volsurfs_tpu_torch.ops.shade import (
    DEG_NR_COEFFS, face_uv_table, make_band_textures, shade_composite_buffers,
)
from volsurfs_tpu_torch.utils import png


def camera_rays(intrinsics, c2w, width: int, height: int):
    """Rays through the pixel centres of one camera, row-major over pixels,
    computed on the device of ``c2w`` (intrinsics [3, 3] and c2w [4, 4]
    float32 tensors, OpenCV convention): (rays_o, rays_d) [H*W, 3].

    Each direction component is written out as the JAX frame path's
    ``raster.tile_rays`` writes it (R[i, 0] x + R[i, 1] y + R[i, 2], then
    divided by the norm), one rounding an operation."""
    dev = c2w.device
    fx, fy, cx, cy = intrinsics[0, 0], intrinsics[1, 1], intrinsics[0, 2], intrinsics[1, 2]
    ix = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    iy = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    xc = ((ix - cx) / fx)[None, :].expand(height, width)
    yc = ((iy - cy) / fy)[:, None].expand(height, width)
    R = c2w[:3, :3]
    d = [R[i, 0] * xc + R[i, 1] * yc + R[i, 2] for i in range(3)]
    norm = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    rays_d = torch.stack([c / norm for c in d], dim=-1).reshape(-1, 3)
    rays_o = c2w[:3, 3].expand(rays_d.shape).contiguous()
    return rays_o, rays_d


class BakedMeshRenderer:
    """Renders a baked scene directory (scene.json + meshes/ + textures/)."""

    def __init__(self, scene_dir: str, bg_color=None, max_texture_res: int | None = None,
                 device="cuda"):
        """max_texture_res: box-downsample texture bands above this
        resolution at load (None keeps the base level).

        device: where the scene lives and the rendering runs; "cuda" (the
        default) raises if there is no CUDA device."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "BakedMeshRenderer: device 'cuda' requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain versions on the CPU")

        with open(os.path.join(scene_dir, "scene.json")) as f:
            self.scene = json.load(f)
        self.sh_degree = int(self.scene.get("sh_degree", 3))
        bg = bg_color or self.scene.get("bg_color", "black")
        self.bg_color = torch.full((3,), 1.0 if bg == "white" else 0.0, device=self.device)

        self.meshes = []
        self.mesh_arrays = []  # (verts, faces, uvs) numpy, for the lazy BVHs
        self.textures_u8 = []  # per mesh: list per band of [H, W, 4, C] uint8
        self.tex_scales = []
        self.ignore_alpha = []
        for mesh_info in self.scene["meshes"]:
            v, f, uv = mesh_io.load_obj(os.path.join(scene_dir, mesh_info["mesh_path"]))
            self.mesh_arrays.append((v, f, uv))
            self.meshes.append(B.make_tensor_mesh(v, f, uv, device=self.device))
            self.ignore_alpha.append(bool(mesh_info.get("ignore_alpha", False)))

            # group the PNGs by band: band d has DEG_NR_COEFFS[d] of them
            per_deg, scales = [], []
            infos = iter(mesh_info["textures"])
            for deg in range(self.sh_degree + 1):
                feats, scale = [], None
                for _ in range(DEG_NR_COEFFS[deg]):
                    info = next(infos)
                    img = png.read(os.path.join(scene_dir, info["texture_path"]))
                    feats.append(np.flipud(img).copy())  # row 0 is v = 1
                    scale = info["texture_scale"]
                tex = np.stack(feats, axis=-1)  # [H, W, 4, C] uint8
                if max_texture_res and tex.shape[0] > max_texture_res:
                    texf = tex.astype(np.float32)
                    while texf.shape[0] > max_texture_res:
                        h2, w2 = texf.shape[0] // 2, texf.shape[1] // 2
                        texf = texf.reshape(h2, 2, w2, 2, *texf.shape[2:]).mean((1, 3))
                    tex = np.clip(np.rint(texf), 0, 255).astype(np.uint8)
                per_deg.append(tex)
                scales.append(scale)
            self.textures_u8.append(per_deg)
            self.tex_scales.append(scales)

        self.nr_meshes = len(self.meshes)
        self.band_textures = make_band_textures(self.textures_u8, self.tex_scales, self.device)
        self.face_uv, self.face_offsets = face_uv_table(
            [(f, uv) for _, f, uv in self.mesh_arrays], self.device)
        self.ignore_alpha_flags = torch.tensor(self.ignore_alpha, device=self.device)
        # back-face cull signs and boxes of the camera entry points
        self.cull_signs = torch.tensor(
            [B.mesh_orientation(v, f) for v, f, _ in self.mesh_arrays], dtype=torch.int32,
            device=self.device)
        self._bbox_min = np.stack([v.astype(np.float32).min(0) for v, _, _ in self.mesh_arrays])
        self._bbox_max = np.stack([v.astype(np.float32).max(0) for v, _, _ in self.mesh_arrays])
        # the BVHs build at the first trace
        self._bvhs = None
        self._stacked_bvh = None
        self._textures_f16 = None

    # ---- lazy pieces ---------------------------------------------------------

    @property
    def bvhs(self):
        if self._bvhs is None:
            self._bvhs = [B.build_bvh(v, f) for v, f, _ in self.mesh_arrays]
        return self._bvhs

    @property
    def stacked_bvh(self):
        if self._stacked_bvh is None:
            self._stacked_bvh = B.stack_bvhs(self.bvhs, self.device)
        return self._stacked_bvh

    @property
    def textures(self):
        """Per mesh, per band [H, W, 4, C] float16 copies of the textures
        (tests / introspection; the device buffer is uint8)."""
        if self._textures_f16 is None:
            self._textures_f16 = [
                [(t.astype(np.float32) / 255.0).astype(np.float16) for t in per_deg]
                for per_deg in self.textures_u8
            ]
        return self._textures_f16

    # ---- core ----------------------------------------------------------------

    def shade_inputs(self, hits, rays_d):
        """The arguments of ``ops/shade._shade_composite_reference`` (K4's
        plain version) for ``trace_all`` hits of rays with directions
        rays_d; without the first, those that follow K2's buffers in
        ``shade_composite_buffers``."""
        return (hits, self.face_uv, self.face_offsets, rays_d, self.band_textures,
                self.ignore_alpha_flags, self.bg_color, self.sh_degree)

    def render_rays(self, rays_o, rays_d, cull=None, width: int = 0):
        """rays [N, 3] float32 on the renderer's device -> {"rgb" [N, 3],
        "bg_transmittance" [N, 1]} float32. cull: None, or ``cull_signs``
        for rays that all start outside every shell (``cameras_outside``).
        width: W > 0 if the rays are a row-major frame W pixels wide (K4
        then shades pixel tiles; the result is the same)."""
        _, tri, u, v = B.trace_all_buffers(self.stacked_bvh, rays_o, rays_d, cull)
        return shade_composite_buffers(tri, u, v, self.face_uv, self.face_offsets, rays_d,
                                       self.band_textures, self.ignore_alpha_flags,
                                       self.bg_color, self.sh_degree, width)

    def cameras_outside(self, cameras) -> bool:
        """True iff every camera centre lies outside every mesh's bounding
        box (grown by 1e-3), the condition for back-face culling."""
        origins = np.stack([np.asarray(c.pose, np.float32)[:3, 3] for c in cameras])
        inside = np.all((origins[:, None, :] >= self._bbox_min[None] - 1e-3)
                        & (origins[:, None, :] <= self._bbox_max[None] + 1e-3), axis=-1)
        return not bool(inside.any())

    def frame_cull(self, cameras):
        """The cull argument of ``render_rays`` for these cameras' rays."""
        return self.cull_signs if self.cameras_outside(cameras) else None

    def camera_tensors(self, cameras):
        """The cameras' intrinsics [B, 3, 3] and poses [B, 4, 4] on the
        device, in one copy (for ``camera_rays``)."""
        intr = np.stack([np.asarray(c.intrinsics, np.float32) for c in cameras])
        poses = np.stack([np.asarray(c.pose, np.float32) for c in cameras])
        return (torch.from_numpy(intr).to(self.device), torch.from_numpy(poses).to(self.device))

    def render(self, camera, chunk_size: int = 65536):
        """Full frame as JAX's ``render`` draws it: the rays of
        ``datasets/cameras.get_camera_rays``, traced with no culling and
        shaded in chunks of rays. Returns [H, W, 3] float32 numpy."""
        rays_o, rays_d = (torch.from_numpy(x).to(self.device) for x in get_camera_rays(camera))
        outs = [self.render_rays(rays_o[i:i + chunk_size], rays_d[i:i + chunk_size])["rgb"]
                for i in range(0, rays_o.shape[0], chunk_size)]
        rgb = torch.cat(outs).cpu().numpy()
        return rgb.reshape(camera.height, camera.width, 3)

    def render_frames_device(self, cameras):
        """All cameras' frames, queued back to back with no host sync after
        the one copy of the cameras to the device. Returns (imgs [B, H, W,
        3] float32, overflow [3] int32 zeros) on the device; tracing has no
        candidate budget, so nothing can overflow."""
        w, h = cameras[0].width, cameras[0].height
        if any(c.width != w or c.height != h for c in cameras):
            raise ValueError("render_frames_device: all cameras need one size")
        intr, poses = self.camera_tensors(cameras)
        cull = self.frame_cull(cameras)
        imgs = torch.empty(len(cameras), h, w, 3, dtype=torch.float32, device=self.device)
        for i in range(len(cameras)):
            rays_o, rays_d = camera_rays(intr[i], poses[i], w, h)
            imgs[i] = self.render_rays(rays_o, rays_d, cull, w)["rgb"].view(h, w, 3)
        return imgs, torch.zeros(3, dtype=torch.int32, device=self.device)

    def render_frame(self, camera):
        """One camera's frame as [H, W, 3] float32 numpy."""
        imgs, _ = self.render_frames_device([camera])
        return imgs[0].cpu().numpy()
