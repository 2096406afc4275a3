"""The port's five-stage pipeline (volsurfs_tpu_torch.pipeline.run_pipeline)
on the CPU, at tests/test_pipeline_e2e.py's sizes with the permutohedral
encoder in place of gridhash (the port has no gridhash) and a few steps a
stage (tests/_pipeline_config.py): every stage runs, at least two shells
come out of the offsets_surfs model with a scene.json that the baked
renderer draws, and a second call resumes every stage from its checkpoint
and trains 0 steps. The quality bars of the JAX test need its full budgets;
chip_smoke.py's pipeline path holds them on the card."""

import os

import numpy as np
import pytest
import torch

from volsurfs_tpu_torch.datasets.mvdataset import MVDataset
from volsurfs_tpu_torch.methods.offsets_surfs import OffsetsSurfs
from volsurfs_tpu_torch.methods.surf import Surf
from volsurfs_tpu_torch.pipeline import run_pipeline
from volsurfs_tpu_torch.renderers.mesh_renderer import BakedMeshRenderer

from _pipeline_config import DATA, INIT_POINTS, PIPELINE_KWARGS, STEPS, hps

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _init_points(monkeypatch):
    monkeypatch.setattr(Surf, "nr_sphere_init_points", INIT_POINTS)
    monkeypatch.setattr(OffsetsSurfs, "nr_offsets_init_points", INIT_POINTS)


def test_run_pipeline_on_the_cpu_and_resume(tmp_path):
    mv = MVDataset("synthetic", "sphere", "", config=DATA)
    kwargs = dict(PIPELINE_KWARGS, device="cpu")
    results = run_pipeline(mv, str(tmp_path), *hps(), **kwargs)
    assert results["steps"] == STEPS
    assert len(results["meshes"]) >= 2
    for v_count, f_count in results["meshes"]:
        assert v_count > 10 and f_count > 10
    for key in ("surf_test_metrics", "offsets_test_metrics", "volsurfs_test_metrics"):
        assert np.isfinite(results[key]["psnr"]), results[key]
    assert os.path.exists(results["scene_json"])
    meshes_dir = os.path.join(results["volsurfs_dir"], "meshes")
    assert sorted(os.listdir(meshes_dir)) == [f"{i}.obj" for i in range(len(results["meshes"]))]

    renderer = BakedMeshRenderer(results["volsurfs_dir"], device="cpu")
    img = renderer.render(mv["test"].cameras[0])
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()

    again = run_pipeline(mv, str(tmp_path), *hps(), eval_splits=False, **kwargs)
    assert again["steps"] == {name: 0 for name in STEPS}
    assert again["meshes"] == results["meshes"]
    for name, method in again["methods"].items():
        assert method.iter_nr == STEPS[name]


def test_run_pipeline_raises_on_a_checkpoint_it_cannot_load(tmp_path):
    """A stage's checkpoint that does not fit its method raises (JAX's
    pipeline trains afresh instead)."""
    mv = MVDataset("synthetic", "sphere", "",
                   config={"width": 16, "height": 16, "nr_train_cameras": 2,
                           "nr_test_cameras": 1})
    bad = tmp_path / "surf" / "checkpoints" / "0000005" / "models"
    bad.mkdir(parents=True)
    (bad / "sdf.pt").write_bytes(b"not a checkpoint")
    with pytest.raises(RuntimeError, match="cannot resume"):
        run_pipeline(mv, str(tmp_path), *hps(), occupancy_res=16, device="cpu")
