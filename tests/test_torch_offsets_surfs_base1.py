"""config/offsets_surfs/base_1.cfg in the port: one surface, with
``are_surfs_colors_indep`` and ``are_surfs_transparency_indep`` set, which
select nothing at one surface (JAX builds one ``rgb_0`` and one ``alpha_0``
either way). It builds at small widths and takes two steps of each phase
through Trainer.train on the CPU (the offsets-init phase has no offset to
fit: its loss is 0); above one surface the flags still raise.
JAX cannot build base_1 itself (its ``small_cumsum`` raises on the empty
offsets axes, ROADMAP.md Queue 3), so there is no JAX side here."""

import os

import numpy as np
import pytest
import torch

from volsurfs_tpu_torch.datasets.mvdataset import MVDataset
from volsurfs_tpu_torch.methods.offsets_surfs import OffsetsSurfs
from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
from volsurfs_tpu_torch.params.hyper_params import get_method_hyper_params
from volsurfs_tpu_torch.training.trainer import Trainer

torch.set_num_threads(2)

CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "config",
                   "offsets_surfs", "base_1.cfg")
# base_1.cfg at small widths, 2 steps a phase
SMALL = dict(sdf_mlp_layers_dims=[16, 16], rgb_mlp_layers_dims=[32, 32], geom_feat_size=8,
             sh_degree=2, training_rays_batch_size=48, is_nr_training_rays_dynamic=False,
             max_nr_samples_per_ray=12, max_nr_imp_samples_per_ray=8, init_phase_end_iter=2,
             color_init_phase_end_iter=4, first_phase_end_iter=6, training_end_iter=8,
             nr_warmup_iters=1, lr_milestones=[10000], curvature_weight=0.0)


def _hp(**overrides):
    hp = get_method_hyper_params("offsets_surfs", CFG)
    for k, v in {**SMALL, **overrides}.items():
        setattr(hp, k, v)
    return hp


def test_base_1_builds_and_steps_every_phase(tmp_path):
    hp = _hp()
    assert hp.are_surfs_colors_indep and hp.are_surfs_transparency_indep
    method = OffsetsSurfs(hp, make_bounding_sphere(1.0), bg_color="white", occupancy_res=16,
                          device="cpu")
    method.nr_offsets_init_points = 2000
    assert method.nr_surfs == 1 and method.main_surf_idx == 0
    assert set(method.models) == {"sdfs", "rgb_0", "alpha_0"}
    mv = MVDataset("synthetic", "sphere", "",
                   config={"width": 24, "height": 24, "nr_train_cameras": 4,
                           "nr_test_cameras": 1})
    trainer = Trainer(method, mv, str(tmp_path), log_every=100)
    before = {k: p.detach().clone() for k, p in method.models.named_parameters()}
    steps = []
    trainer.train(callback=lambda it, m, losses: steps.append(
        (m.phase(it - 1), {k: float(v) for k, v in losses.items()})))
    assert [p for p, _ in steps] == ["offsets_init"] * 2 + ["color_init"] * 2 + \
        ["first"] * 2 + ["second"] * 2
    # the offsets fit has no offset to fit: its loss is 0 and no parameter
    # takes a gradient
    for _, losses in steps[:2]:
        assert losses["loss"] == losses["offsets"] == losses["eikonal_supp"] == 0.0
        assert all(v == 0.0 for k, v in losses.items() if k.startswith("grad_norm"))
    for _, losses in steps[2:]:
        assert all(np.isfinite(v) for v in losses.values()), losses
        assert losses["grad_norm/rgb_0"] > 0.0 and losses["grad_norm/alpha_0"] > 0.0
    moved = [k for k, p in method.models.named_parameters() if not torch.equal(p, before[k])]
    assert any(k.startswith("sdfs") for k in moved) and any(k.startswith("rgb_0") for k in moved)
    out = method.make_render_fn()(*(torch.from_numpy(x) for x in _rays()))
    assert out["surfs_alpha"].shape == (16, 1) and torch.isfinite(out["rgb"]).all()


def _rays():
    o = np.tile(np.float32([[0.0, 0.0, -2.0]]), (16, 1))
    d = np.tile(np.float32([[0.0, 0.0, 1.0]]), (16, 1))
    return o, d


@pytest.mark.parametrize("flag", ["are_surfs_colors_indep", "are_surfs_transparency_indep"])
def test_per_surface_fields_above_one_surface_raise(flag):
    flags = {"are_surfs_colors_indep": False, "are_surfs_transparency_indep": False}
    hp = _hp(nr_inner_surfs=1, **{**flags, flag: True})
    with pytest.raises(NotImplementedError, match="above one surface"):
        OffsetsSurfs(hp, make_bounding_sphere(1.0), bg_color="white", occupancy_res=16,
                     device="cpu")
