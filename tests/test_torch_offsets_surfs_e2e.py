"""The port's offsets_surfs stage on its own, on the CPU, at
tests/test_offsets_surfs_e2e.py's settings (the permutohedral encoder in
place of gridhash, 4,000 points an offsets-init step): every phase trains
through Trainer.train with finite losses, the offsets-init loss falls, the
render carries every surface's opacity, and a checkpoint reloads into a
fresh method that renders alike; then the trainer's CLI from a surf run's
SDF (--models_path)."""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from volsurfs_tpu_torch.datasets.mvdataset import MVDataset
from volsurfs_tpu_torch.methods.offsets_surfs import OffsetsSurfs
from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
from volsurfs_tpu_torch.params.hyper_params import HyperParamsOffsetsSuRFs
from volsurfs_tpu_torch.training import checkpoints
from volsurfs_tpu_torch.training.trainer import Trainer

torch.set_num_threads(2)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
HP = dict(is_nr_training_rays_dynamic=False, training_rays_batch_size=48,
          max_nr_samples_per_ray=12, max_nr_imp_samples_per_ray=8, do_importance_sampling=True,
          init_phase_end_iter=8, color_init_phase_end_iter=16, first_phase_end_iter=30,
          training_end_iter=36, nr_warmup_iters=4, lr=3e-3, lr_milestones=[10000],
          nr_inner_surfs=1, nr_outer_surfs=1, eikonal_weight=0.04,
          support_surfs_eikonal_weight=0.04, offsurface_weight=1e-4, curvature_weight=0.0,
          geom_feat_size=16, sdf_nr_iters_for_c2f=0, sdf_encoding_type="permutohash",
          rgb_pos_encoder_type="permutohash", nr_samples_bg=8)
DATA = {"width": 24, "height": 24, "nr_train_cameras": 4, "nr_test_cameras": 1}
# the offsets-init steps' random points: 4,000 of JAX's 30,000, a cut of the
# CPU time (the plain permutohedral lookup runs 24 levels of torch ops)
OFFSETS_INIT_POINTS = 4000


def _method(hp, seed=0):
    method = OffsetsSurfs(hp, make_bounding_sphere(1.0), bg_color="white", occupancy_res=16,
                          device="cpu", seed=seed)
    method.nr_offsets_init_points = OFFSETS_INIT_POINTS
    return method


def test_offsets_surfs_phases_train_render_and_round_trip(tmp_path):
    hp = HyperParamsOffsetsSuRFs(**HP)
    mv = MVDataset("synthetic", "sphere", "", config=DATA)
    method = _method(hp)
    assert method.nr_surfs == 3 and method.main_surf_idx == 1
    trainer = Trainer(method, mv, str(tmp_path), log_every=8)
    losses = {phase: [] for phase in ("offsets_init", "color_init", "first", "second")}
    trainer.train(callback=lambda it, m, l: losses[m.phase(it - 1)].append(float(l["loss"])))
    assert [len(v) for v in losses.values()] == [8, 8, 14, 6]
    assert all(np.isfinite(v).all() for v in losses.values())
    assert losses["offsets_init"][-1] < losses["offsets_init"][0]

    cam = mv["test"].cameras[0]
    out = trainer.render_camera(cam)
    assert out["rgb"].shape == (24, 24, 3) and np.isfinite(out["rgb"]).all()
    assert out["surfs_alpha"].shape == (24, 24, 3)  # every surface's opacity

    fresh = _method(hp, seed=1)
    checkpoints.load_checkpoint(trainer.ckpt_dir, fresh)
    assert fresh.iter_nr == method.iter_nr == hp.training_end_iter
    assert torch.equal(fresh.grid.occupied, method.grid.occupied)
    reloaded = Trainer(fresh, mv, str(tmp_path / "reloaded"))
    got = reloaded.render_camera(cam)
    for key in ("rgb", "surfs_alpha"):
        np.testing.assert_array_equal(got[key], out[key])


def test_offsets_surfs_cli_from_a_surf_run(tmp_path):
    """python -m volsurfs_tpu_torch.training.trainer --method offsets_surfs
    --models_path <a surf run's models> --device cpu: 2 offsets-init steps
    at small widths. The main surface is frozen there and its Adam moments
    stay 0, so the run's shared encoder and main head are the surf's."""
    from volsurfs_tpu_torch.methods.surf import Surf
    from volsurfs_tpu_torch.params.hyper_params import HyperParamsSuRF

    widths = {"sdf_mlp_layers_dims": [16, 16], "geom_feat_size": 8,
              "rgb_mlp_layers_dims": [32, 32], "sh_degree": 1}
    surf = Surf(HyperParamsSuRF(**widths, use_occupancy_grid=False), make_bounding_sphere(1.0),
                bg_color="white", device="cpu", seed=5)
    with torch.no_grad():
        surf.models["sdf"].encoder.table.uniform_(-0.1, 0.1)
    models = tmp_path / "surf_models"
    models.mkdir()
    torch.save(surf.models["sdf"].state_dict(), models / "sdf.pt")

    hp = {**widths, "init_phase_end_iter": 4, "nr_inner_surfs": 2, "nr_outer_surfs": 0,
          "training_rays_batch_size": 32, "max_nr_samples_per_ray": 12,
          "max_nr_imp_samples_per_ray": 8, "do_importance_sampling": 1,
          "support_surfs_eikonal_weight": 0.04}
    cfg = tmp_path / "cfg"
    cfg.mkdir()
    (cfg / "exp.cfg").write_text(
        "hyper_params: {\n" + "\n".join(f"    {k}: {json.dumps(v)}" for k, v in hp.items())
        + "\n}\n")
    (cfg / "data.cfg").write_text(
        "synthetic: {\n    bg_color: \"white\"\n    width: 16\n    height: 16\n"
        "    nr_train_cameras: 2\n    nr_test_cameras: 1\n}\n")
    runs = tmp_path / "runs"
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run(
        [sys.executable, "-m", "volsurfs_tpu_torch.training.trainer", "--method",
         "offsets_surfs", "--runs_path", str(runs), "--run_id", "r", "--data_config",
         str(cfg / "data.cfg"), "--exp_config", str(cfg / "exp.cfg"), "--models_path",
         str(models), "--train_iters", "2", "--occupancy_res", "16", "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "iter 2/2" in proc.stdout and "test metrics" in proc.stdout
    ckpt = runs / "offsets_surfs" / "default" / "sphere" / "r" / "checkpoints" / "0000002"
    assert sorted(os.listdir(ckpt / "models")) == [
        "alpha_0.pt", "rgb_0.pt", "sdfs.pt", "train_state.pt"]
    sdfs = torch.load(ckpt / "models" / "sdfs.pt", weights_only=True)
    for name, value in surf.models["sdf"].state_dict().items():
        target = name.replace("encoder.", "pos_encoder.", 1).replace("mlp.", "mlp_sdf.", 1)
        assert torch.equal(sdfs[target], value), name
