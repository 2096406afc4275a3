"""The port's surf stage with the trained background, on its own on the
CPU: tests/test_torch_surf_e2e.py's short training (tests/_stage_config.py,
180 of its 220 steps) on the white sphere scene, with ``bg_color="trained"``, through
Trainer.train: its test psnr passes that test's bar, and the background
field learns the scene's white; and the trainer CLI's ``--models_path``,
which carries a previous stage's trained background into the next."""

import os

import numpy as np
import torch

from volsurfs_tpu_torch.datasets.mvdataset import MVDataset
from volsurfs_tpu_torch.methods.surf import Surf
from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
from volsurfs_tpu_torch.params.hyper_params import HyperParamsSuRF
from volsurfs_tpu_torch.training import trainer as T

from _stage_config import SURF_DATA, SURF_HP, SURF_INIT_SPHERE_RADIUS, SURF_OCCUPANCY_RES

torch.set_num_threads(2)

PSNR_BAR = 16.0  # tests/test_surf_e2e.py's
# the largest mean |rgb_bg - 1| over the test camera's background pixels
BG_WHITE_BAR = 0.1


def test_surf_with_the_trained_background_learns_the_scene(tmp_path):
    # 180 of the configuration's 220 steps (60 sphere-init), for the file's
    # time on the CPU
    hp = HyperParamsSuRF(**{**SURF_HP, "training_end_iter": 180})
    mv = MVDataset("synthetic", "sphere", "", config=SURF_DATA)
    assert mv.bg_color == "white"
    method = Surf(hp, make_bounding_sphere(1.0), bg_color="trained",
                  init_sphere_radius=SURF_INIT_SPHERE_RADIUS,
                  occupancy_res=SURF_OCCUPANCY_RES, device="cpu")
    method.nr_sphere_init_points = 4000  # tests/test_torch_surf_e2e.py's cut
    trainer = T.Trainer(method, mv, str(tmp_path), log_every=50)
    trainer.train()
    means = trainer.eval_split("test", max_cameras=1)
    print("test", means)
    assert means["psnr"] > PSNR_BAR, means

    cam = mv["test"].cameras[0]
    from volsurfs_tpu_torch.datasets.cameras import get_camera_rays

    rays_o, rays_d = (torch.from_numpy(x) for x in get_camera_rays(cam))
    with torch.no_grad():
        res = method.render_rays(rays_o, rays_d)
    background = mv["test"].masks[0].reshape(-1) < 0.5
    assert background.mean() > 0.3
    err = float(torch.abs(res["rgb_bg"] - 1.0)[torch.from_numpy(background)].mean())
    print("mean |rgb_bg - 1| on the background pixels", err)
    assert err < BG_WHITE_BAR, err


def test_models_path_carries_the_background(tmp_path, monkeypatch):
    """--models_path DIR loads DIR/bg.pt into a method with a trained
    background (as JAX's bg.msgpack), whatever the method."""
    hp = {"appearance_predict_sh_coeffs": 1, "sdf_mlp_layers_dims": "[16, 16]",
          "geom_feat_size": 8, "rgb_mlp_layers_dims": "[32, 32]", "sh_degree": 1,
          "training_rays_batch_size": 64, "max_nr_samples_per_ray": 16,
          "max_nr_imp_samples_per_ray": 8, "do_importance_sampling": 1}
    (tmp_path / "exp.cfg").write_text(
        "hyper_params: {\n" + "\n".join(f"    {k}: {v}" for k, v in hp.items()) + "\n}\n")
    (tmp_path / "data.cfg").write_text(
        "synthetic: {\n    bg_color: \"trained\"\n    width: 16\n    height: 16\n    nr_train_cameras: 2\n"
        "    nr_test_cameras: 1\n}\n")
    src = Surf(HyperParamsSuRF(), make_bounding_sphere(1.0), occupancy_res=8, device="cpu",
               seed=7)
    models = tmp_path / "models"
    models.mkdir()
    torch.save(src.models["bg"].state_dict(), models / "bg.pt")
    taken = {}
    monkeypatch.setattr(T.Trainer, "train", lambda self, *a, **k: taken.setdefault(
        "method", self.method))
    run_dir = T.main(["--method", "surf", "--runs_path", str(tmp_path / "runs"), "--run_id", "r",
                      "--data_config", str(tmp_path / "data.cfg"), "--exp_config",
                      str(tmp_path / "exp.cfg"), "--occupancy_res", "8", "--models_path",
                      str(models), "--device", "cpu"])
    assert os.path.isdir(run_dir)
    got = taken["method"].models["bg"].state_dict()
    for k, v in src.models["bg"].state_dict().items():
        assert torch.equal(got[k], v), k
    assert not np.allclose(got["encoder.table"].numpy(), 0.0)
