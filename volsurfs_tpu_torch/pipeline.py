"""The whole VolSurfs pipeline (counterpart of volsurfs_tpu/pipeline.py):
surf -> offsets_surfs -> bake meshes -> volsurfs -> bake textures and
scene.json, on one device.

    from volsurfs_tpu_torch.pipeline import run_pipeline
    results = run_pipeline(mv_data, runs_root, surf_hp, offsets_hp, volsurfs_hp)

The stages communicate through ``runs_root`` (surf/, offsets_surfs/,
volsurfs/ with its meshes/, textures/ and scene.json). Each training stage
resumes from the latest checkpoint in its own directory and trains on to
its ``training_end_iter`` (0 steps if it is there); a checkpoint that does
not load raises, where the JAX package trains afresh. The offsets_surfs
stage starts from the surf stage's SDF (``OffsetsSurfs.load_main_sdf``);
the shells are extracted from the offsets_surfs model on the device
(``baker.extract_meshes_from_offsets_surfs``), simplified and atlased on
the host, and the volsurfs stage trains on them as they are in memory.
"""

from __future__ import annotations

import os

from volsurfs_tpu_torch.baking import baker
from volsurfs_tpu_torch.methods.offsets_surfs import OffsetsSurfs
from volsurfs_tpu_torch.methods.surf import Surf
from volsurfs_tpu_torch.methods.volsurfs import VolSurfs, resolve_device
from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
from volsurfs_tpu_torch.training import checkpoints
from volsurfs_tpu_torch.training.trainer import Trainer


def _train_stage(method, mv_data, run_dir: str, seed: int):
    """Resume method from run_dir's latest checkpoint if there is one (a
    checkpoint that does not load raises), then train it to its end.
    Returns (trainer, the steps trained)."""
    trainer = Trainer(method, mv_data, run_dir, seed=seed)
    if checkpoints.get_last_checkpoint_in_path(trainer.ckpt_dir) is not None:
        try:
            trainer.load_checkpoint()
        except Exception as e:
            raise RuntimeError(f"[pipeline] cannot resume {run_dir} from its checkpoint: "
                               f"{e}") from e
        print(f"[pipeline] resumed {run_dir} at iter {method.iter_nr}", flush=True)
    start = method.iter_nr
    trainer.train()
    return trainer, method.iter_nr - start


def _carry_bg(src, dst):
    """A trained background model of src into dst, where both have one."""
    if "bg" in src.models and "bg" in dst.models:
        dst.models["bg"].load_state_dict(src.models["bg"].state_dict())


def run_pipeline(mv_data, runs_root: str, surf_hp, offsets_hp, volsurfs_hp,
                 occupancy_res: int = 256, mesh_extraction_res: int = 256,
                 simplify_ratio: float = 0.025, init_sphere_radius: float | None = None,
                 seed: int = 0, eval_splits: bool = True, device="cuda"):
    """Runs the three training stages and the two baking stages. Returns a
    dict: each stage's run directory, steps trained and (with eval_splits)
    test metrics, the shells' (vertices, faces), the scene.json path and
    the trained methods."""
    device = resolve_device(device)
    bound = make_bounding_sphere(mv_data.scene_radius)
    bg_color = mv_data.bg_color
    init_radius = (init_sphere_radius if init_sphere_radius is not None
                   else mv_data.init_sphere_scale * float(mv_data.scene_radius))
    results = {"steps": {}}

    def train(name, method, metrics_key):
        run_dir = os.path.join(runs_root, name)
        trainer, results["steps"][name] = _train_stage(method, mv_data, run_dir, seed)
        if eval_splits:
            results[metrics_key] = trainer.eval_split("test")
        return run_dir

    # stage 1: surf
    surf = Surf(surf_hp, bound, bg_color=bg_color, init_sphere_radius=init_radius,
                occupancy_res=occupancy_res, device=device, seed=seed)
    results["surf_dir"] = train("surf", surf, "surf_test_metrics")

    # stage 2: offsets_surfs from the surf stage's SDF
    offs = OffsetsSurfs(offsets_hp, bound, bg_color=bg_color, occupancy_res=occupancy_res,
                        device=device, seed=seed)
    offs.load_main_sdf(surf.models["sdf"].state_dict())
    _carry_bg(surf, offs)
    results["offsets_dir"] = train("offsets_surfs", offs, "offsets_test_metrics")

    # stage 3: the shells, extracted from the offsets_surfs model, simplified
    # and atlased
    raw = baker.extract_meshes_from_offsets_surfs(offs, resolution=mesh_extraction_res)
    meshes = baker.simplify_and_atlas(raw, simplify_ratio)
    vs_dir = os.path.join(runs_root, "volsurfs")
    os.makedirs(vs_dir, exist_ok=True)
    baker.save_meshes(vs_dir, meshes)
    results["raw_meshes"] = [(v.shape[0], f.shape[0]) for v, f in raw]
    results["meshes"] = [(v.shape[0], f.shape[0]) for v, f, _ in meshes]

    # stage 4: the volsurfs stage on those shells
    vs = VolSurfs(volsurfs_hp, meshes, bg_color=bg_color, bounding_primitive=bound,
                  device=device, seed=seed)
    _carry_bg(offs, vs)
    results["volsurfs_dir"] = train("volsurfs", vs, "volsurfs_test_metrics")

    # stage 5: the textures and scene.json
    if volsurfs_hp.using_neural_textures:
        meshes_info = baker.bake_textures(vs, vs_dir)
        results["scene_json"] = baker.export_scene_json(
            vs_dir, meshes_info, mv_data, bg_color=bg_color or "black",
            sh_degree=volsurfs_hp.sh_degree)
    results["methods"] = {"surf": surf, "offsets_surfs": offs, "volsurfs": vs}
    return results
