"""The port's Trainer, checkpoints, evaluation and CLIs against volsurfs_tpu's,
on the two sphere shells of tests/test_volsurfs_e2e.py (sh_degree 1, 64^2
textures; tests/_torch_stage.py), on the CPU."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from volsurfs_tpu.datasets.mvdataset import MVDataset as JMVDataset
from volsurfs_tpu.training import checkpoints as JCK
from volsurfs_tpu.training.trainer import Trainer as JTrainer
from volsurfs_tpu.utils import evaluation as JE
from volsurfs_tpu_torch.baking.baker import save_meshes
from volsurfs_tpu_torch.datasets.mvdataset import MVDataset
from volsurfs_tpu_torch.renderers.mesh_renderer import BakedMeshRenderer
from volsurfs_tpu_torch.training import callbacks as CB
from volsurfs_tpu_torch.training import checkpoints
from volsurfs_tpu_torch.training import trainer as TT
from volsurfs_tpu_torch.training.trainer import Trainer
from volsurfs_tpu_torch.utils import evaluation as TE

from _torch_stage import DATA, HP, port_method, shell_meshes, textured_jax_pair

torch.set_num_threads(2)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RGB_ATOL = 2e-3  # render_camera against JAX's jitted render, as the slice's other renders
METRIC_ATOL = 1e-5  # psnr / ssim / lpips_rf of the two packages on the same images


def _mv():
    return MVDataset("synthetic", "sphere", "", config=DATA)


def test_quality_bar_after_30_steps(tmp_path):
    """A port copy of tests/test_volsurfs_e2e.py's bar, through Trainer.train
    on the CPU: falling finite losses, test psnr > 15 after 30 steps, the
    solid inner shell blocks rays and the background shows around it."""
    mv = _mv()
    method = port_method()
    timer = CB.StepTimerCallback("cpu")
    trainer = Trainer(method, mv, str(tmp_path), log_every=10,
                      callbacks=CB.CallbacksGroup([timer]))
    seen = []
    assert trainer.train(callback=lambda it, m, losses: seen.append(it)) is method
    losses = timer.losses()
    assert method.iter_nr == 30 and seen == list(range(1, 31)) and len(losses) == 30
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert [it for it, _ in trainer.loss_history] == [10, 20, 30]

    out = trainer.render_camera(mv["test"].cameras[0])
    assert out["rgb"].shape == (32, 32, 3) and np.isfinite(out["rgb"]).all()
    means = trainer.eval_split("test", max_cameras=1)
    assert means["psnr"] > 15.0, means
    bg_T = out["bg_transmittance"]
    assert bg_T.min() < 0.1 and bg_T.max() > 0.9
    assert os.path.exists(tmp_path / "results" / "test.csv")
    assert os.listdir(tmp_path / "checkpoints") == ["0000030"]


def test_render_camera_and_eval_split_match_jax(tmp_path):
    """render_camera on the same parameters as JAX's Trainer.render_camera
    (rgb and bg_transmittance within 2e-3), and eval_split's means equal to
    the JAX package's metrics of the same images within 1e-5."""
    jmethod, jstate, tmethod = textured_jax_pair(seed=1)
    jtrainer = JTrainer(jmethod, JMVDataset("synthetic", "sphere", "", config=DATA),
                        str(tmp_path / "jax"))
    mv = _mv()
    trainer = Trainer(tmethod, mv, str(tmp_path / "port"))
    images = []
    for cam, jcam in zip(mv["test"].cameras, jtrainer.mv_data["test"].cameras):
        ref = jtrainer.render_camera(jstate, jcam)
        got = trainer.render_camera(cam, chunk_size=300)
        for key in ("rgb", "bg_transmittance"):
            assert got[key].shape == ref[key].shape
            np.testing.assert_allclose(got[key], ref[key], atol=RGB_ATOL, rtol=0, err_msg=key)
        assert 0.05 < (ref["bg_transmittance"] < 0.5).mean() < 0.95
        images.append(got["rgb"].clip(0, 1))
    means = trainer.eval_split("test")
    gts = mv["test"].rgbs
    for name, fn in (("psnr", JE.psnr), ("ssim", JE.ssim), ("lpips_rf", JE.lpips_rf)):
        ref = float(np.mean([fn(gt, img) for gt, img in zip(gts, images)]))
        assert abs(means[name] - ref) <= METRIC_ATOL, (name, means[name], ref)
    # the metric functions themselves, on one pair of images
    rng = np.random.default_rng(0)
    a, b = rng.uniform(0, 1, (2, 40, 36, 3)).astype(np.float32)
    for name in ("psnr", "ssim", "lpips_rf"):
        got, ref = getattr(TE, name)(a, b), getattr(JE, name)(a, b)
        assert abs(got - ref) <= METRIC_ATOL, name
    with open(tmp_path / "port" / "results" / "test.csv") as f:
        assert f.read().splitlines()[0] == "id,psnr,ssim,lpips_rf"


def test_supersampled_render_camera_averages_jittered_frames(tmp_path):
    """nr_test_rays_per_pixel = 3: three jittered frames from the
    trainer's generator, averaged; close to the unjittered frame."""
    mv = _mv()
    plain = Trainer(port_method(), mv, str(tmp_path / "a")).render_camera(mv["test"].cameras[0])
    trainer = Trainer(port_method(), mv, str(tmp_path / "b"))
    trainer.method.hp.nr_test_rays_per_pixel = 3
    state = trainer.generator.get_state()
    out = trainer.render_camera(mv["test"].cameras[0])
    assert not torch.equal(trainer.generator.get_state(), state)
    assert not np.array_equal(out["rgb"], plain["rgb"])
    assert np.abs(out["rgb"] - plain["rgb"]).mean() < 0.05


def _params(method):
    return {f"{name}.{k}": v.detach().clone()
            for name, module in method.models.items() for k, v in module.state_dict().items()}


def test_checkpoint_resume_takes_the_same_steps(tmp_path):
    """Train 4 steps (Trainer.train saves the checkpoint), then 2 more;
    a fresh method that loads the 4-step checkpoint and trains 2 steps
    ends bit for bit where the uninterrupted run did: parameters, Adam's
    moments, the learning rate and the batch generator's draws."""
    import shutil

    mv = _mv()
    a = Trainer(port_method(), mv, str(tmp_path / "a"), seed=3)
    a.train(end_iter=4)
    assert os.listdir(tmp_path / "a" / "checkpoints") == ["0000004"]
    shutil.copytree(tmp_path / "a" / "checkpoints", tmp_path / "b" / "checkpoints")
    a.train(end_iter=6)
    # keep_previous=False (the trainer's) deleted iteration 4
    assert os.listdir(tmp_path / "a" / "checkpoints") == ["0000006"]

    b = Trainer(port_method(seed=9), mv, str(tmp_path / "b"), seed=11)
    assert checkpoints.get_last_checkpoint_in_path(str(tmp_path / "b" / "checkpoints")) == 4
    b.load_checkpoint()
    assert b.method.iter_nr == 4
    b.train(end_iter=6)
    pa, pb = _params(a.method), _params(b.method)
    assert pa.keys() == pb.keys()
    for key in pa:
        assert torch.equal(pa[key], pb[key]), key
    sa, sb = a.method.optimizer.state_dict(), b.method.optimizer.state_dict()
    for idx in sa["state"]:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa["state"][idx][key], sb["state"][idx][key])
    assert a.method.scheduler.get_last_lr() == b.method.scheduler.get_last_lr()
    assert torch.equal(a.generator.get_state(), b.generator.get_state())

    # keep_previous=True keeps older iterations
    checkpoints.save_checkpoint(str(tmp_path / "b" / "checkpoints"), b.method, keep_previous=True)
    b.method.iter_nr = 7
    checkpoints.save_checkpoint(str(tmp_path / "b" / "checkpoints"), b.method, keep_previous=True)
    assert sorted(os.listdir(tmp_path / "b" / "checkpoints")) == ["0000006", "0000007"]
    with pytest.raises(FileNotFoundError):
        checkpoints.load_checkpoint(str(tmp_path / "none"), b.method)


def test_jax_checkpoint_carries_over(tmp_path):
    """JAX trains 2 steps and saves its checkpoint (flax msgpack); the
    port reads it with its own msgpack reader, and its render_camera
    matches JAX's within 2e-3. Only parameters come over."""
    jmethod, jstate, _ = textured_jax_pair(seed=2)
    jmv = JMVDataset("synthetic", "sphere", "", config=DATA)
    jtrainer = JTrainer(jmethod, jmv, str(tmp_path / "jax"))
    jstate = jtrainer.train(jstate, end_iter=2)
    ckpt = str(tmp_path / "jax" / "checkpoints")
    assert JCK.get_last_checkpoint_in_path(ckpt) == 2

    method = port_method()
    before = _params(method)
    assert checkpoints.load_jax_params(ckpt, method) is method
    assert method.iter_nr == 0 and not method.optimizer.state
    moved = _params(method)
    assert any(not torch.equal(before[k], moved[k]) for k in before)
    flat = checkpoints.read_flax_msgpack(os.path.join(ckpt, "0000002", "models", "rgb_1.msgpack"))
    np.testing.assert_array_equal(
        flat["params"]["neural_textures_1"]["encoding"]["table"],
        np.asarray(jstate.params["rgb_1"]["params"]["neural_textures_1"]["encoding"]["table"]))

    trainer = Trainer(method, _mv(), str(tmp_path / "port"))
    for cam, jcam in zip(trainer.mv_data["test"].cameras, jmv["test"].cameras):
        ref = jtrainer.render_camera(jstate, jcam)["rgb"]
        got = trainer.render_camera(cam)["rgb"]
        np.testing.assert_allclose(got, ref, atol=RGB_ATOL, rtol=0)


def test_callbacks_read_losses_only_at_their_cadence(tmp_path):
    class Lazy:
        """A 0-d loss that counts how often it is read."""

        reads = 0

        def __float__(self):
            Lazy.reads += 1
            return 0.25

    logger = CB.MetricsLoggerCallback(str(tmp_path), log_every=5)
    state = CB.StateCallback()
    group = CB.CallbacksGroup([logger, state])
    group.training_started()
    for it in range(1, 11):
        group.iter_ended(iter_nr=it, losses={"loss": Lazy()})
    group.training_ended()
    assert Lazy.reads == 2 and state.iters_per_sec > 0
    lines = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert [r["iter"] for r in lines] == [5, 10] and lines[1]["train/loss_loss"] == 0.25


@pytest.mark.parametrize("name", ["nerf", "unknown"])
def test_make_method_builds_nerf_and_refuses_unknown_methods(name):
    """Every method of the JAX package is ported: make_method("nerf")
    builds the port's NeRF, and a name outside METHODS raises."""
    from volsurfs_tpu_torch.methods.nerf import NeRF
    from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
    from volsurfs_tpu_torch.params.hyper_params import HyperParamsNeRF

    hp = HyperParamsNeRF(density_mlp_layers_dims=[8], geom_feat_size=4,
                         rgb_mlp_layers_dims=[8], sh_degree=1)
    if name == "unknown":
        with pytest.raises(ValueError, match="unknown method"):
            TT.make_method(name, hp, make_bounding_sphere(1.0), "white", device="cpu")
        return
    method = TT.make_method(name, hp, make_bounding_sphere(1.0), "white", device="cpu",
                            occupancy_res=8)
    assert isinstance(method, NeRF) and sorted(method.models) == ["density", "rgb"]
    assert method.grid.res == 8 and method.device == torch.device("cpu")


def test_entry_points_need_cuda_by_default(monkeypatch, tmp_path):
    """Trainer runs where its method runs, and both CLIs default to
    --device cuda: without a card each raises instead of running on the
    CPU."""
    from volsurfs_tpu_torch.baking import baker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(SimpleNamespace(device=torch.device("cuda")), _mv(), str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        TT.main(["--method", "volsurfs", "--runs_path", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        baker.main(["--method", "volsurfs", "--run_id", "x", "--runs_path", str(tmp_path),
                    "--extract_textures"])
    with pytest.raises(RuntimeError, match="cuda"):
        baker.main(["--method", "offsets_surfs", "--run_id", "x", "--runs_path", str(tmp_path),
                    "--extract_meshes", "--simplify_meshes", "--compute_meshes_xatlas"])


def test_trainer_and_baker_clis_on_the_cpu(tmp_path):
    """python -m ...training.trainer, then python -m ...baking.baker
    --extract_textures, in a temporary runs path; the baked scene.json
    loads in the port's BakedMeshRenderer and renders the test camera."""
    cfg = tmp_path / "cfg"
    cfg.mkdir()
    hjson_list = lambda xs: "[" + ", ".join(str(x) for x in xs) + "]"  # noqa: E731
    lines = [f"    {k}: {hjson_list(v) if isinstance(v, list) else int(v) if isinstance(v, bool) else v}"
             for k, v in HP.items()]
    (cfg / "exp.cfg").write_text("hyper_params: {\n" + "\n".join(lines) + "\n}\n")
    (cfg / "data.cfg").write_text(
        "synthetic: {\n    bg_color: \"white\"\n    width: 24\n    height: 24\n"
        "    nr_train_cameras: 4\n    nr_test_cameras: 1\n}\n")
    meshes = tmp_path / "shells"
    save_meshes(str(meshes), list(shell_meshes()), subdir="")
    runs = tmp_path / "runs"
    common = ["--method", "volsurfs", "--runs_path", str(runs), "--run_id", "r",
              "--data_config", str(cfg / "data.cfg"), "--device", "cpu"]
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run(
        [sys.executable, "-m", "volsurfs_tpu_torch.training.trainer", *common,
         "--exp_config", str(cfg / "exp.cfg"), "--meshes_path", str(meshes),
         "--train_iters", "3"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "iter 3/3" in proc.stdout and "test metrics" in proc.stdout
    run_dir = runs / "volsurfs" / "default" / "sphere" / "r"
    assert os.listdir(run_dir / "checkpoints") == ["0000003"]
    assert os.path.exists(run_dir / "config" / "exp_config.cfg")

    proc = subprocess.run(
        [sys.executable, "-m", "volsurfs_tpu_torch.baking.baker", *common,
         "--meshes_path", str(meshes), "--extract_textures"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "checkpoint at iter 3" in proc.stdout
    assert sorted(os.listdir(run_dir / "meshes")) == ["0.obj", "1.obj"]
    assert len(os.listdir(run_dir / "textures")) == 8
    with open(run_dir / "scene.json") as f:
        scene = json.load(f)
    assert scene["resolution"] == [24, 24] and sorted(scene["cameras"]) == ["test", "train"]
    renderer = BakedMeshRenderer(str(run_dir), device="cpu")
    cam = MVDataset("synthetic", "sphere", "",
                    config={"width": 24, "height": 24, "nr_test_cameras": 1})["test"].cameras[0]
    img = renderer.render(cam)
    assert img.shape == (24, 24, 3) and np.isfinite(img).all() and img.min() < 0.9

