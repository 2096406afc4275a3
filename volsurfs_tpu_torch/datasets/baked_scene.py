"""Baked scenes for the renderer's smoke run and timings.

``COMMITTED_SCENE`` is the 5-shell scene baked at 256x256 and committed in
``runs/pipeline_tpu_256/volsurfs/`` (sh_degree 2, bands of 512-128 texels;
its quality bar is ``baked_render_psnr`` in ``runs/pipeline_tpu_256/
results.json``). ``write_full_width_scene`` writes a scene at the widths
of the JAX package's ``bench.py`` (sh_degree 3, bands of [2048, 1024, 512,
256] texels, texture_scale (-15, 15), a white background, ``ignore_alpha``
on mesh 0) with random texels from a seed, since the render's throughput
does not depend on texture content. Its geometry is the committed scene's
five shells, not ``bench.py``'s bumpy spheres: the port has no marching
cubes or simplifier yet.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

from volsurfs_tpu_torch.ops.shade import DEG_NR_COEFFS
from volsurfs_tpu_torch.utils import png

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
COMMITTED_SCENE = os.path.join(REPO, "runs", "pipeline_tpu_256", "volsurfs")
COMMITTED_RESULTS = os.path.join(REPO, "runs", "pipeline_tpu_256", "results.json")

FULL_WIDTH_RES = (2048, 1024, 512, 256)  # bench.py's texture pyramid
FULL_WIDTH_SH_DEGREE = 3


def committed_psnr_bar() -> float:
    """The committed scene's ``baked_render_psnr``."""
    with open(COMMITTED_RESULTS) as f:
        return float(json.load(f)["baked_render_psnr"])


def write_random_scene(scene_dir: str, mesh_files, textures_res, sh_degree: int,
                       seed: int = 0) -> str:
    """Write scene.json, copies of the OBJ files and random uint8 band PNGs
    (filter 0, zlib level 1) into scene_dir, as bench.py's ``build_scene``
    lays them out: texture_scale (-15, 15), a white background,
    ``ignore_alpha`` on mesh 0. Returns the scene.json path."""
    os.makedirs(os.path.join(scene_dir, "meshes"), exist_ok=True)
    os.makedirs(os.path.join(scene_dir, "textures"), exist_ok=True)
    rng = np.random.default_rng(seed)
    meshes_info = []
    for mesh_idx, src in enumerate(mesh_files):
        mesh_path = os.path.join("meshes", f"{mesh_idx}.obj")
        shutil.copyfile(src, os.path.join(scene_dir, mesh_path))
        textures_info = []
        for deg in range(sh_degree + 1):
            res = int(textures_res[deg])
            for feat in range(DEG_NR_COEFFS[deg]):
                fname = f"mesh_{mesh_idx}_texture_{deg}_feature_{feat}.png"
                png.write(os.path.join(scene_dir, "textures", fname),
                          rng.integers(0, 256, (res, res, 4), dtype=np.uint8))
                textures_info.append({
                    "texture_path": os.path.join("textures", fname),
                    "texture_scale": (-15.0, 15.0),
                    "texture_resolution": (res, res),
                })
        meshes_info.append({"mesh_path": mesh_path, "textures": textures_info,
                            "ignore_alpha": mesh_idx == 0})
    path = os.path.join(scene_dir, "scene.json")
    with open(path, "w") as f:
        json.dump({"bg_color": "white", "sh_degree": sh_degree, "meshes": meshes_info}, f,
                  indent=2)
    return path


def committed_mesh_files():
    """The committed scene's OBJ files, in its scene.json order."""
    with open(os.path.join(COMMITTED_SCENE, "scene.json")) as f:
        return [os.path.join(COMMITTED_SCENE, m["mesh_path"]) for m in json.load(f)["meshes"]]


def write_full_width_scene(scene_dir: str) -> str:
    """bench.py's widths on the committed shells, into scene_dir, texels
    from seed 0."""
    return write_random_scene(scene_dir, committed_mesh_files(), FULL_WIDTH_RES,
                              FULL_WIDTH_SH_DEGREE)
