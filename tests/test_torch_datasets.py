"""The port's datasets and config params against volsurfs_tpu's: camera
rays (with and without jitter), the supersampled ray batch, the hard
procedural scene, the blender and DTU loaders on the fixtures of
tests/test_blender_loader.py and tests/test_aux.py, and the three config
tiers read from config/*.cfg."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from volsurfs_tpu.datasets import cameras as JC
from volsurfs_tpu.datasets import mvdataset as JM
from volsurfs_tpu.datasets import synthetic as JS
from volsurfs_tpu.params import params as JP
from volsurfs_tpu_torch.datasets import cameras as TC
from volsurfs_tpu_torch.datasets import mvdataset as TM
from volsurfs_tpu_torch.datasets import synthetic as TS
from volsurfs_tpu_torch.datasets.tensor_reel import get_next_rays_batch, make_tensor_reel
from volsurfs_tpu_torch.params import params as TP

torch.set_num_threads(2)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CFG = os.path.join(REPO, "config")


def _camera(width=24, height=16, seed=0):
    cams, _, _ = TS.make_synthetic_split(2, width, height, seed=seed, scene="sphere")
    return cams[1]


def _jax_camera(cam):
    return JC.Camera(cam.intrinsics, cam.pose, cam.width, cam.height, cam.camera_id)


def test_camera_rays_without_jitter_equal_jax():
    cam = _camera()
    ref_o, ref_d = (np.asarray(x) for x in JC.get_camera_rays(_jax_camera(cam)))
    o, d = TC.get_camera_rays(cam)
    assert o.shape == d.shape == (16 * 24, 3) and d.dtype == np.float32
    np.testing.assert_allclose(o, ref_o, atol=1e-6, rtol=0)
    np.testing.assert_allclose(d, ref_d, atol=1e-6, rtol=0)


def test_camera_rays_jitter_inside_each_pixel():
    """With a generator, each ray passes through a point drawn in [0, 1)^2
    of its own pixel: reprojected, it lands in that pixel, not at its
    centre."""
    cam = _camera()
    gen = torch.Generator().manual_seed(5)
    _, d = TC.get_camera_rays(cam, jitter_pixels=True, generator=gen)
    d_cam = d @ cam.pose[:3, :3]
    pix = (d_cam @ cam.intrinsics.T)[:, :2] / d_cam[:, 2:]
    jj, ii = np.meshgrid(np.arange(24), np.arange(16), indexing="xy")
    sub = pix - np.stack([jj.reshape(-1), ii.reshape(-1)], -1)
    assert sub.min() > -1e-4 and sub.max() < 1.0 + 1e-4
    assert np.abs(sub - 0.5).max() > 0.4  # not the centres
    # another generator state, other jitter; the same state, the same rays
    _, d2 = TC.get_camera_rays(cam, jitter_pixels=True, generator=gen)
    _, d3 = TC.get_camera_rays(cam, jitter_pixels=True,
                               generator=torch.Generator().manual_seed(5))
    assert not np.array_equal(d, d2) and np.array_equal(d, d3)


def test_camera_matrices_and_resize_equal_jax():
    cam = _camera(32, 24)
    jcam = _jax_camera(cam)
    np.testing.assert_array_equal(cam.get_opengl_projection_matrix(),
                                  jcam.get_opengl_projection_matrix())
    np.testing.assert_array_equal(cam.get_opengl_matrix_world(), jcam.get_opengl_matrix_world())
    small, jsmall = cam.resize(2), jcam.resize(2)
    assert (small.width, small.height) == (jsmall.width, jsmall.height) == (16, 12)
    np.testing.assert_array_equal(small.intrinsics, jsmall.intrinsics)
    pose_gl = cam.get_opengl_matrix_world()
    np.testing.assert_array_equal(TC.opengl_to_opencv_pose(pose_gl),
                                  JC.opengl_to_opencv_pose(pose_gl))


@pytest.mark.parametrize("jitter", [False, True])
def test_rays_batch_repeats_pixels(jitter):
    """nr_rays_per_pixel=4: B // 4 pixels, each repeated 4 times in a row
    with its ground truth; with jitter every ray has its own sub-pixel
    offset, without it the 4 rays of a pixel are one ray."""
    cams, rgbs, masks = TS.make_synthetic_split(3, 16, 16, seed=0)
    reel = make_tensor_reel(cams, rgbs, masks, device="cpu")
    gen = torch.Generator().manual_seed(0)
    b = get_next_rays_batch(reel, gen, 64, jitter_pixels=jitter, nr_rays_per_pixel=4)
    assert b["rays_d"].shape == (64, 3) and b["gt_rgb"].shape == (64, 3)
    for key in ("camera_idx", "gt_rgb", "gt_mask", "rays_o"):
        groups = b[key].reshape(16, 4, -1)
        assert torch.equal(groups, groups[:, :1].expand_as(groups)), key
    d = b["rays_d"].reshape(16, 4, 3)
    assert torch.equal(d, d[:, :1].expand_as(d)) != jitter
    assert len(torch.unique(b["camera_idx"])) > 1


def test_rays_batch_without_supersampling_matches_reel_pixels():
    """nr_rays_per_pixel=1, no jitter: each ray goes through its pixel's
    centre, as get_camera_rays' ray of that pixel."""
    cams, rgbs, masks = TS.make_synthetic_split(3, 16, 16, seed=0)
    reel = make_tensor_reel(cams, rgbs, masks, device="cpu")
    b = get_next_rays_batch(reel, torch.Generator().manual_seed(1), 32, jitter_pixels=False)
    for i in range(32):
        cam = int(b["camera_idx"][i])
        _, d = TC.get_camera_rays(cams[cam])
        match = np.abs(d - b["rays_d"][i].numpy()).max(-1).argmin()
        np.testing.assert_allclose(d[match], b["rays_d"][i].numpy(), atol=1e-6)
        np.testing.assert_array_equal(rgbs[cam].reshape(-1, 3)[match], b["gt_rgb"][i].numpy())


def test_hard_scene_equals_jax():
    cams, rgbs, masks = TS.make_synthetic_split(2, 20, 20, seed=0, scene="hard")
    jcams, jrgbs, jmasks = JS.make_synthetic_split(2, 20, 20, seed=0, scene="hard")
    assert 0.05 < masks.mean() < 0.6
    np.testing.assert_allclose(rgbs, jrgbs, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(masks, jmasks)
    for c, j in zip(cams, jcams):
        np.testing.assert_array_equal(c.pose, j.pose)


# ---- loaders -----------------------------------------------------------------


@pytest.fixture(scope="module")
def blender_scene(tmp_path_factory):
    """tests/test_blender_loader.py's fixture: 4 frames a split of 16x16
    RGBA PNGs (alpha 1 on the left half), OpenGL poses, extensionless
    file paths."""
    root = tmp_path_factory.mktemp("datasets")
    scene = root / "blender" / "tiny"
    W = H = 16
    for split in ("train", "test"):
        frames = []
        os.makedirs(scene / split, exist_ok=True)
        for i in range(4):
            ang = 2 * np.pi * i / 4 + (0.3 if split == "test" else 0.0)
            eye = np.asarray([2.0 * np.cos(ang), 2.0 * np.sin(ang), 1.0])
            pose_gl = JC.look_at_pose(eye) @ np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
            img = np.zeros((H, W, 4), np.uint8)
            img[..., 0] = 10 * (i + 1)
            img[..., 1] = 100
            img[:, : W // 2, 3] = 255
            Image.fromarray(img).save(scene / split / f"r_{i}.png")
            frames.append({"file_path": f"{split}/r_{i}", "transform_matrix": pose_gl.tolist()})
        with open(scene / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    return str(root)


def _assert_same_dataset(got, ref):
    assert sorted(got.splits) == sorted(ref.splits)
    assert (got.scene_radius, got.bg_color) == (ref.scene_radius, ref.bg_color)
    for name in ref.splits:
        g, r = got[name], ref[name]
        assert len(g.cameras) == len(r.cameras)
        np.testing.assert_array_equal(g.rgbs, r.rgbs)
        np.testing.assert_array_equal(g.masks, r.masks)
        for a, b in zip(g.cameras, r.cameras):
            assert (a.width, a.height, a.camera_id) == (b.width, b.height, b.camera_id)
            np.testing.assert_array_equal(a.intrinsics, b.intrinsics)
            np.testing.assert_array_equal(a.pose, b.pose)


@pytest.mark.parametrize("config", [{"pose_scale": 0.25}, {"subsample_factor": 2, "test_skip": 2}])
def test_blender_loader_equals_jax(blender_scene, config):
    got = TM.MVDataset("blender", "tiny", blender_scene, config=config)
    ref = JM.MVDataset("blender", "tiny", blender_scene, config=config)
    _assert_same_dataset(got, ref)
    half = got["train"].rgbs.shape[2] // 2
    assert got["train"].masks[0, :, half:].max() == 0.0
    assert got["train"].rgbs[0, :, half:].min() == 1.0


def test_dtu_loader_equals_jax(tmp_path):
    """tests/test_aux.py's DTU fixture: 6 cameras of random rotations,
    RGB images and greyscale masks."""
    rng = np.random.default_rng(0)
    scene = tmp_path / "dtu" / "scan1"
    (scene / "image").mkdir(parents=True)
    (scene / "mask").mkdir()
    K = np.array([[420.0, 0, 32], [0, 420.0, 24], [0, 0, 1]])
    cams = {}
    for i in range(6):
        Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        if np.linalg.det(Q) < 0:
            Q[:, 0] *= -1
        t = rng.standard_normal(3) * 0.2 + np.array([0, 0, 2.5])
        world = np.eye(4)
        world[:3, :4] = K @ np.concatenate([Q, t[:, None]], axis=1)
        cams[f"world_mat_{i}"] = world
        cams[f"scale_mat_{i}"] = np.eye(4)
        Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)).save(
            scene / "image" / f"{i:06d}.png")
        mask = np.full((48, 64), 255, np.uint8)
        mask[:, : 8 * i] = 0
        Image.fromarray(mask).save(scene / "mask" / f"{i:06d}.png")
    np.savez(scene / "cameras.npz", **cams)
    for config in ({"test_camera_freq": 3}, {"subsample_factor": 2, "scene_radius_mult": 1.5}):
        got = TM.MVDataset("dtu", "scan1", str(tmp_path), config=config)
        ref = JM.MVDataset("dtu", "scan1", str(tmp_path), config=config)
        _assert_same_dataset(got, ref)
    assert got.bg_color == "black" and got.scene_radius == 1.5


def test_loaders_reject_what_they_cannot_read(tmp_path):
    """Without PIL the port reads PNGs only, and of those 8-bit greyscale,
    RGB and RGBA (with or without alpha); anything else raises a clear
    error."""
    from volsurfs_tpu_torch.utils import png

    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(tmp_path / "p.png")
    with pytest.raises(ValueError, match="colour type 3"):
        png.read(str(tmp_path / "p.png"))
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(tmp_path / "d16.png")
    with pytest.raises(ValueError, match="bit depth 16"):
        png.read(str(tmp_path / "d16.png"))
    with pytest.raises(ValueError, match="only PNG"):
        TM._read_image(str(tmp_path / "x.jpg"))


# ---- params ------------------------------------------------------------------


def test_params_read_the_configs_as_jax():
    for method in ("volsurfs", "surf", "nerf"):
        got = TP.TrainParams(method, os.path.join(CFG, "train_config.cfg"))
        ref = JP.TrainParams(method, os.path.join(CFG, "train_config.cfg"))
        assert vars(got) == vars(ref)
    for dataset, scene in (("synthetic", "sphere"), ("dtu", "scan1"), ("blender", "lego"),
                           ("shelly", "khady")):
        got = TP.DataParams(dataset, scene, os.path.join(CFG, "data_config.cfg"))
        ref = JP.DataParams(dataset, scene, os.path.join(CFG, "data_config.cfg"))
        assert vars(got) == vars(ref)
    got = TP.PathsParams(os.path.join(CFG, "paths_config.cfg"))
    ref = JP.PathsParams(os.path.join(CFG, "paths_config.cfg"))
    assert vars(got) == vars(ref)
    assert TP.PathsParams(datasets="/d", runs="/r").runs_path == "/r"


def test_init_run_lays_out_the_run_directory(tmp_path):
    cfg = os.path.join(CFG, "train_config.cfg")
    run_dir, run_id = TP.init_run(str(tmp_path), "volsurfs", "default", "sphere",
                                  run_id="a", config_files={"train_config": cfg})
    assert run_dir == os.path.join(str(tmp_path), "volsurfs", "default", "sphere", "a")
    assert os.path.exists(os.path.join(run_dir, "config", "train_config.cfg"))
    assert TP.init_run(str(tmp_path), "volsurfs", "default", "sphere",
                       continue_training=True) == (run_dir, "a")
    jdir, jid = JP.init_run(str(tmp_path / "j"), "volsurfs", "default", "sphere", run_id="a")
    assert os.path.relpath(jdir, str(tmp_path / "j")) == os.path.relpath(run_dir, str(tmp_path))

