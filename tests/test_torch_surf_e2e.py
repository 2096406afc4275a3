"""The port's surf stage on its own, on the CPU: a short training at
tests/test_surf_e2e.py's settings (tests/_stage_config.py: the
permutohedral encoder in place of gridhash, 4,000 points a sphere-init
step) through Trainer.train, which must reach that test's PSNR bar, with a
checkpoint round trip; and the trainer's CLI for 3 steps."""

import os
import subprocess
import sys

import numpy as np
import torch

from volsurfs_tpu_torch.datasets.mvdataset import MVDataset
from volsurfs_tpu_torch.methods.surf import Surf
from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
from volsurfs_tpu_torch.params.hyper_params import HyperParamsSuRF
from volsurfs_tpu_torch.training import checkpoints
from volsurfs_tpu_torch.training.trainer import Trainer

from _stage_config import SURF_DATA, SURF_HP, SURF_INIT_SPHERE_RADIUS, SURF_OCCUPANCY_RES

torch.set_num_threads(2)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PSNR_BAR = 16.0  # tests/test_surf_e2e.py's
# the sphere-init steps' random points: 4,000 of JAX's 30,000, a cut of the
# CPU time of the 60 steps (the plain permutohedral lookup runs 24 levels of
# torch ops); the SDF still converges to the sphere
SPHERE_INIT_POINTS = 4000


def _surf(hp, seed=0):
    method = Surf(hp, make_bounding_sphere(1.0), bg_color="white",
                  init_sphere_radius=SURF_INIT_SPHERE_RADIUS, occupancy_res=SURF_OCCUPANCY_RES,
                  device="cpu", seed=seed)
    method.nr_sphere_init_points = SPHERE_INIT_POINTS
    return method


def test_surf_trains_renders_and_round_trips(tmp_path):
    hp = HyperParamsSuRF(**SURF_HP)
    mv = MVDataset("synthetic", "sphere", "", config=SURF_DATA)
    trainer = Trainer(_surf(hp), mv, str(tmp_path), log_every=50)
    sphere, data = [], []

    def log(it, method, losses):
        (sphere if it <= hp.init_phase_end_iter else data).append(float(losses["loss"]))

    method = trainer.train(callback=log)
    assert np.isfinite(sphere).all() and np.isfinite(data).all()
    assert sphere[-1] < sphere[0]
    means = trainer.eval_split("test", max_cameras=1)
    assert means["psnr"] > PSNR_BAR, means
    print("test", means)

    # the checkpoint holds the grid: a fresh method (other seed) renders alike
    fresh = _surf(hp, seed=1)
    checkpoints.load_checkpoint(trainer.ckpt_dir, fresh)
    assert fresh.iter_nr == method.iter_nr == hp.training_end_iter
    assert torch.equal(fresh.grid.occupied, method.grid.occupied)
    cam = mv["test"].cameras[0]
    reloaded = Trainer(fresh, mv, str(tmp_path / "reloaded"))
    np.testing.assert_array_equal(reloaded.render_camera(cam)["rgb"],
                                  trainer.render_camera(cam)["rgb"])


def test_surf_cli_on_the_cpu(tmp_path):
    """python -m volsurfs_tpu_torch.training.trainer --method surf --device
    cpu: 2 sphere-init steps and 1 data step at small widths, then the
    evaluation of both splits, in a temporary runs path."""
    hp = {"appearance_predict_sh_coeffs": 1, "init_phase_end_iter": 2,
          "sdf_mlp_layers_dims": "[16, 16]", "geom_feat_size": 8, "rgb_mlp_layers_dims": "[32, 32]", "sh_degree": 1,
          "training_rays_batch_size": 64, "max_nr_samples_per_ray": 16,
          "max_nr_imp_samples_per_ray": 8, "do_importance_sampling": 1}
    cfg = tmp_path / "cfg"
    cfg.mkdir()
    (cfg / "exp.cfg").write_text(
        "hyper_params: {\n" + "\n".join(f"    {k}: {v}" for k, v in hp.items()) + "\n}\n")
    (cfg / "data.cfg").write_text(
        "synthetic: {\n    bg_color: \"white\"\n    width: 16\n    height: 16\n"
        "    nr_train_cameras: 2\n    nr_test_cameras: 1\n}\n")
    runs = tmp_path / "runs"
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run(
        [sys.executable, "-m", "volsurfs_tpu_torch.training.trainer", "--method", "surf",
         "--runs_path", str(runs), "--run_id", "r", "--data_config", str(cfg / "data.cfg"),
         "--exp_config", str(cfg / "exp.cfg"), "--train_iters", "3", "--occupancy_res", "16",
         "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "iter 3/3" in proc.stdout and "test metrics" in proc.stdout
    run_dir = runs / "surf" / "default" / "sphere" / "r"
    assert os.listdir(run_dir / "checkpoints") == ["0000003"]
    assert sorted(os.listdir(run_dir / "checkpoints" / "0000003" / "models")) == [
        "rgb.pt", "sdf.pt", "train_state.pt"]
