"""Baker: mesh extraction, simplification, UV atlasing, texture baking and
scene.json export for the real-time viewer (counterpart of
volsurfs_tpu/baking/baker.py).

    python -m volsurfs_tpu_torch.baking.baker --method offsets_surfs --run_id ID \\
        --extract_meshes --simplify_meshes --compute_meshes_xatlas [--device cuda]
    python -m volsurfs_tpu_torch.baking.baker --method volsurfs --run_id ID \\
        --extract_textures [--device cuda]

``extract_meshes_from_offsets_surfs`` evaluates every surface of a trained
offsets_surfs model at once on a dense grid on the method's device (the
shared encoder's K6 lookup without grads, 65,536 points a chunk) and
marches each surface's column there (``marching.py``), inner to outer;
``extract_meshes_from_surf`` does the same for a surf SDF's level sets.
``simplify_and_atlas`` decimates each mesh (``simplify.py``, native) and
charts and packs its UVs (``uv_atlas.py``, host numpy and scipy), dropping
empty extractions. ``--extract_bg_mesh`` fuses the depths a method renders
from the training cameras (``tsdf.py``).

``bake_textures`` evaluates every SH band of every shell's rgb and alpha
neural texture at its texel centres (``NeuralTexture.forward(bake=True)``,
in chunks of ``batch_size`` uvs without autograd, on the method's device),
turns the squeezed [0, 1] values into 8-bit (clip, x255, round half to
even; rows flipped so that PNG row 0 is the texel row nearest v = 0, as
OpenGL stores a texture) and writes one RGBA PNG per SH
coefficient (rgb + alpha) through ``utils/png.py``. ``export_scene_json``
writes the scene.json that ``BakedMeshRenderer`` and the WebGL viewer
load. Stages communicate through the run directory (meshes/, textures/,
scene.json).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from volsurfs_tpu_torch.baking import mesh_io
from volsurfs_tpu_torch.baking.marching import (
    evaluate_grid,
    extract_mesh_from_fn,
    grid_origin_spacing,
    marching_tetrahedra,
)
from volsurfs_tpu_torch.methods.volsurfs import resolve_device
from volsurfs_tpu_torch.models.textures import DEG_NR_COEFFS
from volsurfs_tpu_torch.utils import png


def extract_meshes_from_surf(method, resolution: int = 256, levels=(0.0,)):
    """Level-set meshes [(verts, faces), ...] of a trained surf SDF at its
    iter_nr, on the method's device."""
    bounds = float(method.radius)
    return [extract_mesh_from_fn(lambda p: method._sdf(p, method.iter_nr)[0][..., 0],
                                 resolution, bounds, level=level, device=method.device)
            for level in levels]


def extract_meshes_from_offsets_surfs(method, resolution: int = 256):
    """The zero-level-set meshes [(verts, faces), ...] of every surface of a
    trained offsets_surfs model at its iter_nr, inner -> outer: one
    evaluation of all surfaces on the grid, then a march a surface, all on
    the method's device."""
    bounds = float(method.radius)
    values = evaluate_grid(lambda p: method._sdfs(p, method.iter_nr)[0][..., 0], resolution,
                           bounds, device=method.device)
    origin, spacing = grid_origin_spacing(resolution, bounds)
    return [marching_tetrahedra(values[..., k], origin, spacing)
            for k in range(values.shape[-1])]


def simplify_and_atlas(meshes, target_faces_ratio: float = 0.025):
    """Simplify, then atlas, each mesh; returns [(verts, faces, uvs), ...].

    Empty extractions (a level set that left the grid, e.g. offsets not yet
    converged) are dropped with a warning, as the JAX package drops them.
    The meshes are simplified in threads at once (the native call holds no
    Python lock), then atlased one after another."""
    from concurrent.futures import ThreadPoolExecutor

    from volsurfs_tpu_torch.baking.simplify import simplify_mesh
    from volsurfs_tpu_torch.baking.uv_atlas import compute_atlas

    kept = []
    for i, (v, f) in enumerate(meshes):
        if f.shape[0] < 4:
            print(f"WARNING: mesh {i} extraction is empty/degenerate "
                  f"({f.shape[0]} faces); skipping this shell", flush=True)
            continue
        kept.append((v, f))
    with ThreadPoolExecutor(max(1, len(kept))) as pool:
        simplified = list(pool.map(lambda m: simplify_mesh(*m, target_faces_ratio), kept))
    out = []
    for (v, f), (sv, sf) in zip(kept, simplified):
        if sf.shape[0] < 4:
            sv, sf = v, f  # simplification degenerated; keep the original
        out.append(compute_atlas(sv, sf))
    return out


def save_meshes(run_dir: str, meshes, subdir: str = "meshes"):
    d = os.path.join(run_dir, subdir)
    os.makedirs(d, exist_ok=True)
    paths = []
    for i, mesh in enumerate(meshes):
        path = os.path.join(d, f"{i}.obj")
        if len(mesh) == 3:
            mesh_io.save_obj(path, mesh[0], mesh[1], mesh[2])
        else:
            mesh_io.save_obj(path, mesh[0], mesh[1])
        paths.append(path)
    return paths


def load_meshes(run_dir: str, subdir: str = "meshes"):
    d = os.path.join(run_dir, subdir)
    meshes = []
    for name in sorted(os.listdir(d), key=lambda s: int(os.path.splitext(s)[0])):
        meshes.append(mesh_io.load_obj(os.path.join(d, name)))
    return meshes


def _texel_center_uvs(res: int):
    """uv coords of all texel centers, row-major over (y, x), v flipped
    (the texture convention of models/textures.py)."""
    x = (np.arange(res) + 0.5) / res
    y = (np.arange(res) + 0.5) / res
    uu, vv = np.meshgrid(x, 1.0 - y, indexing="xy")
    return np.stack([uu.reshape(-1), vv.reshape(-1)], -1).astype(np.float32)


def _bake_band_u8(texture, uvs, batch_size: int):
    """One band texture at uvs [N, 2] (on its device), in chunks, as uint8
    [N, C] on the host: clip to [0, 1], x255, round half to even (as
    ``np.round``). One copy to the host a band."""
    outs = []
    with torch.no_grad():
        for i in range(0, uvs.shape[0], batch_size):
            outs.append(texture(uvs[i:i + batch_size], bake=True))
        tex = torch.cat(outs)
        u8 = torch.round(torch.clamp(tex, 0.0, 1.0) * 255.0).to(torch.uint8)
    return u8.cpu().numpy()


def bake_textures(method, run_dir: str, batch_size: int = 2**16, stats: dict | None = None):
    """Write every SH band of every mesh's rgb + alpha textures as PNGs
    under run_dir/textures/ and return the meshes_info blocks of
    scene.json. One RGBA PNG per SH coefficient; texture_scale records the
    band's value range. The alpha planes of mesh 0 are ones when its shell
    is solid (``ignore_alpha``).

    stats, if given, gains ``eval_s`` (texture evaluation, to the host
    copies), ``write_s`` (PNG encoding and writing), ``bytes`` (PNG bytes
    written), ``pngs`` and ``texel_uvs`` (uvs evaluated)."""
    resolve_device(method.device)
    hp = method.hp
    if not hp.using_neural_textures:
        raise ValueError("texture extraction requires neural textures")
    tex_dir = os.path.join(run_dir, "textures")
    os.makedirs(tex_dir, exist_ok=True)
    totals = dict(eval_s=0.0, write_s=0.0, bytes=0, pngs=0, texel_uvs=0)

    meshes_info = []
    for mesh_idx in range(method.nr_meshes):
        rgb_model = method.models[f"rgb_{mesh_idx if hp.are_volsurfs_colors_indep else 0}"]
        alpha_model = method.models[f"alpha_{mesh_idx if hp.are_volsurfs_alphas_indep else 0}"]
        ignore_alpha = method.solid_inner and mesh_idx == 0

        textures_info = []
        for deg in range(hp.sh_degree + 1):
            res = int(hp.textures_res[deg])
            nr_coeffs = DEG_NR_COEFFS[deg]
            t = time.perf_counter()
            uvs = torch.from_numpy(_texel_center_uvs(res)).to(method.device)
            rgb = _bake_band_u8(rgb_model.neural_textures[deg], uvs, batch_size)
            rgb = rgb.reshape(res, res, 3, nr_coeffs)
            totals["texel_uvs"] += res * res
            if ignore_alpha:
                alpha = np.full((res, res, 1, nr_coeffs), 255, np.uint8)
            else:
                alpha = _bake_band_u8(alpha_model.neural_textures[deg], uvs, batch_size)
                alpha = alpha.reshape(res, res, 1, nr_coeffs)
                totals["texel_uvs"] += res * res
            totals["eval_s"] += time.perf_counter() - t

            t = time.perf_counter()
            tex = np.flipud(np.concatenate([rgb, alpha], axis=2))  # [res, res, 4, C]
            for feat in range(nr_coeffs):
                fname = f"mesh_{mesh_idx}_texture_{deg}_feature_{feat}.png"
                path = os.path.join(tex_dir, fname)
                png.write(path, tex[:, :, :, feat])
                totals["bytes"] += os.path.getsize(path)
                totals["pngs"] += 1
                textures_info.append(
                    {
                        "texture_path": os.path.join("textures", fname),
                        "texture_scale": (
                            -float(hp.sh_range[deg]),
                            float(hp.sh_range[deg]),
                        ),
                        "texture_resolution": (res, res),
                    }
                )
            totals["write_s"] += time.perf_counter() - t

        meshes_info.append(
            {
                "mesh_path": os.path.join("meshes", f"{mesh_idx}.obj"),
                "textures": textures_info,
                "ignore_alpha": ignore_alpha,
            }
        )
    if stats is not None:
        stats.update(totals)
    return meshes_info


def export_scene_json(run_dir: str, meshes_info, mv_data=None, bg_color="black",
                      sh_degree: int = 3):
    """scene.json for the WebGL viewer: resolution, bg_color, sh_degree,
    meshes, and the cameras of every split with OpenGL matrices."""
    scene_info = {"bg_color": bg_color or "black", "sh_degree": sh_degree,
                  "meshes": meshes_info}
    if mv_data is not None:
        split = next(iter(mv_data.splits.values()))
        cam0 = split.cameras[0]
        scene_info["resolution"] = [cam0.width, cam0.height]
        scene_info["cameras"] = {}
        for split_name, split in mv_data.splits.items():
            scene_info["cameras"][split_name] = {
                cam.camera_id: {
                    "projectionMatrix": cam.get_opengl_projection_matrix().tolist(),
                    "matrixWorld": cam.get_opengl_matrix_world().tolist(),
                }
                for cam in split.cameras
            }
    path = os.path.join(run_dir, "scene.json")
    with open(path, "w") as f:
        json.dump(scene_info, f, indent=2)
    return path


def copy_meshes_renumbered(meshes_dir: str, mesh_files, run_dir: str):
    """scene.json names the shells meshes/{i}.obj: copy the selection
    (mesh_files of meshes_dir, in method order) to run_dir/meshes/ as
    0.obj .. k-1.obj unless it is there already under those names. The
    bytes are read first, since with a subset taken in place a destination
    can be a source not read yet."""
    local = os.path.join(run_dir, "meshes")
    if (os.path.abspath(meshes_dir) == os.path.abspath(local)
            and mesh_files == [f"{i}.obj" for i in range(len(mesh_files))]):
        return
    blobs = []
    for name in mesh_files:
        with open(os.path.join(meshes_dir, name), "rb") as f:
            blobs.append(f.read())
    os.makedirs(local, exist_ok=True)
    for i, blob in enumerate(blobs):
        with open(os.path.join(local, f"{i}.obj"), "wb") as f:
            f.write(blob)


def main(argv=None):
    """Baker CLI: loads a trained run from its directory and runs the stages
    asked for: --extract_meshes (into run_dir/meshes_raw/), --simplify_meshes
    / --compute_meshes_xatlas (both simplify and atlas, into run_dir/meshes/),
    --extract_bg_mesh (run_dir/bg_mesh.obj), --extract_textures (textures/
    and scene.json of a volsurfs run). --device defaults to cuda (on a host
    without CUDA it raises unless --device cpu)."""
    import argparse

    from volsurfs_tpu_torch.datasets.mvdataset import MVDataset
    from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
    from volsurfs_tpu_torch.params.hyper_params import get_method_hyper_params
    from volsurfs_tpu_torch.params.params import DataParams, PathsParams
    from volsurfs_tpu_torch.training import checkpoints
    from volsurfs_tpu_torch.training.trainer import (
        METHODS, load_shells, make_method,
    )

    parser = argparse.ArgumentParser("volsurfs_tpu_torch baker")
    parser.add_argument("--method", required=True, choices=list(METHODS))
    parser.add_argument("--dataset", default="synthetic")
    parser.add_argument("--scene", default="sphere")
    parser.add_argument("--exp_name", default="default")
    parser.add_argument("--run_id", required=True)
    parser.add_argument("--paths_config", default=None)
    parser.add_argument("--data_config", default=None)
    parser.add_argument("--datasets_path", default=None)
    parser.add_argument("--runs_path", default=None)
    parser.add_argument("--meshes_path", default=None)
    parser.add_argument("--extract_meshes", action="store_true")
    parser.add_argument("--simplify_meshes", action="store_true")
    parser.add_argument("--compute_meshes_xatlas", action="store_true")
    parser.add_argument("--extract_bg_mesh", action="store_true")
    parser.add_argument("--extract_textures", action="store_true")
    parser.add_argument("--extraction_res", type=int, default=256)
    parser.add_argument("--simplify_ratio", type=float, default=0.025)
    parser.add_argument("--occupancy_res", type=int, default=256)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)

    cfg_dir = os.path.join(os.path.dirname(__file__), "..", "..", "config")
    paths_cfg = args.paths_config or os.path.join(cfg_dir, "paths_config.cfg")
    data_cfg = args.data_config or os.path.join(cfg_dir, "data_config.cfg")
    paths = PathsParams(paths_cfg if os.path.exists(paths_cfg) else None,
                        datasets=args.datasets_path, runs=args.runs_path)
    data_params = DataParams(args.dataset, args.scene,
                             data_cfg if os.path.exists(data_cfg) else None)

    run_dir = os.path.join(paths.runs_path, args.method, args.exp_name, args.scene, args.run_id)
    exp_cfg = os.path.join(run_dir, "config", "exp_config.cfg")
    if not os.path.exists(exp_cfg):
        raise SystemExit(f"no exp config under {run_dir}/config")
    hp = get_method_hyper_params(args.method, exp_cfg)

    mv_data = MVDataset(args.dataset, args.scene, paths.datasets_path,
                        config=dict(data_params.dict))
    method_kwargs = {}
    if args.method == "volsurfs":
        meshes_dir = args.meshes_path or os.path.join(run_dir, "meshes")
        mesh_files, method_kwargs["meshes"] = load_shells(meshes_dir, hp)
    else:
        method_kwargs["occupancy_res"] = args.occupancy_res
    method = make_method(args.method, hp, make_bounding_sphere(mv_data.scene_radius),
                         mv_data.bg_color or data_params.bg_color, seed=args.seed,
                         device=device, **method_kwargs)
    checkpoints.load_checkpoint(os.path.join(run_dir, "checkpoints"), method)
    print(f"loaded {args.method} checkpoint at iter {method.iter_nr}", flush=True)

    if args.extract_meshes:
        if args.method == "offsets_surfs":
            raw = extract_meshes_from_offsets_surfs(method, resolution=args.extraction_res)
        elif args.method == "surf":
            raw = extract_meshes_from_surf(method, resolution=args.extraction_res)
        else:
            raise ValueError("--extract_meshes needs a surf or offsets_surfs run")
        save_meshes(run_dir, raw, "meshes_raw")
        print(f"extracted {len(raw)} meshes -> {run_dir}/meshes_raw", flush=True)

    if args.simplify_meshes or args.compute_meshes_xatlas:
        src = os.path.join(run_dir, "meshes_raw")
        raw = [mesh_io.load_obj(os.path.join(src, name))[:2]
               for name in sorted(f for f in os.listdir(src) if f.endswith(".obj"))]
        meshes = simplify_and_atlas(raw, args.simplify_ratio)
        save_meshes(run_dir, meshes)
        print(f"simplified+atlased {len(meshes)} meshes -> {run_dir}/meshes", flush=True)

    if args.extract_bg_mesh:
        from volsurfs_tpu_torch.baking.tsdf import fuse_depths
        from volsurfs_tpu_torch.training.trainer import Trainer

        trainer = Trainer(method, mv_data, run_dir)
        depths, cams = [], []
        for cam in mv_data["train"].cameras:
            out_frame = trainer.render_camera(cam)
            if "depth" in out_frame:
                depths.append(out_frame["depth"][..., 0])
                cams.append(cam)
        if depths:
            v, f = fuse_depths(depths, cams, resolution=args.extraction_res // 2,
                               bounds=float(mv_data.scene_radius) * 2.0, device=device)
            mesh_io.save_obj(os.path.join(run_dir, "bg_mesh.obj"), v, f)
            print(f"bg mesh: {v.shape[0]} verts", flush=True)

    if args.extract_textures:
        if args.method != "volsurfs":
            raise ValueError("--extract_textures requires volsurfs")
        copy_meshes_renumbered(meshes_dir, mesh_files, run_dir)
        meshes_info = bake_textures(method, run_dir)
        scene_path = export_scene_json(run_dir, meshes_info, mv_data,
                                       bg_color=mv_data.bg_color or "black",
                                       sh_degree=hp.sh_degree)
        print(f"scene.json -> {scene_path}", flush=True)
    return run_dir


if __name__ == "__main__":
    main()
