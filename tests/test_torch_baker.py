"""The port's baker against volsurfs_tpu's on the same parameters: two
sphere shells, sh_degree 1, 64^2 textures, hash tables from a numpy seed
(tests/_torch_stage.py). The band PNGs hold the same texel bytes, the
scene.json files match key for key, and the scene baked by the port renders
alike in the JAX package's BakedMeshRenderer and in the port's."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from volsurfs_tpu.baking import baker as JB
from volsurfs_tpu.datasets.mvdataset import MVDataset as JMVDataset
from volsurfs_tpu.renderers.mesh_renderer import BakedMeshRenderer as JRenderer
from volsurfs_tpu_torch.baking import baker
from volsurfs_tpu_torch.datasets.mvdataset import MVDataset
from volsurfs_tpu_torch.renderers.mesh_renderer import BakedMeshRenderer
from volsurfs_tpu_torch.utils import png

from _torch_stage import DATA, shell_meshes, textured_jax_pair

torch.set_num_threads(2)

# A texel byte is round(255 * sigmoid(MLP output)) after the straight-through
# 8-bit quantisation; the MLP's float32 sums run in another order in XLA
# than in torch, so a value within a few float32 steps of a .5 rounding
# boundary may land one step apart. At most 0.1% of the bytes may differ,
# each by at most 1; on this test's parameters all 131,072 bytes are equal.
MAX_BYTE_DIFF = 1
MAX_DIFFERING_SHARE = 1e-3
RENDER_ATOL = 2e-3  # rgb of the two renderers on the same baked scene


@pytest.fixture(scope="module")
def baked(tmp_path_factory):
    """The same textured parameters baked by JAX into one run directory and
    by the port into another; returns (jax dir, port dir, meshes_info of
    each, the port's stats)."""
    jmethod, jstate, tmethod = textured_jax_pair(seed=3)
    jdir = str(tmp_path_factory.mktemp("jax_bake"))
    tdir = str(tmp_path_factory.mktemp("port_bake"))
    for d in (jdir, tdir):
        baker.save_meshes(d, list(shell_meshes()))
    jinfo = JB.bake_textures(jmethod, jstate, jdir)
    JB.export_scene_json(jdir, jinfo, JMVDataset("synthetic", "sphere", "", config=DATA),
                         bg_color="white", sh_degree=1)
    stats = {}
    tinfo = baker.bake_textures(tmethod, tdir, stats=stats)
    baker.export_scene_json(tdir, tinfo, MVDataset("synthetic", "sphere", "", config=DATA),
                            bg_color="white", sh_degree=1)
    return jdir, tdir, jinfo, tinfo, stats


def test_bake_writes_the_same_texel_bytes_as_jax(baked):
    """Every PNG's decoded RGBA bytes, PIL-read on the JAX side and read by
    utils/png.py on the port's (the files differ in their zlib streams):
    equal in all but at most 0.1% of the bytes, those by at most 1."""
    jdir, tdir, jinfo, tinfo, stats = baked
    names = sorted(os.listdir(os.path.join(jdir, "textures")))
    assert names == sorted(os.listdir(os.path.join(tdir, "textures")))
    # 2 meshes x (1 + 3 coefficients)
    assert len(names) == stats["pngs"] == 8
    total = differ = 0
    for name in names:
        ref = np.asarray(Image.open(os.path.join(jdir, "textures", name)))
        got = png.read(os.path.join(tdir, "textures", name))
        assert got.shape == ref.shape == (64, 64, 4)
        diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
        assert diff.max() <= MAX_BYTE_DIFF, name
        total += diff.size
        differ += int((diff > 0).sum())
        # the textures vary: a flip of rows or a constant plane would show
        assert len(np.unique(ref[..., 0])) > 20, name
    assert differ <= MAX_DIFFERING_SHARE * total, (differ, total)
    # mesh 0 is solid: its alpha planes are 255
    assert (png.read(os.path.join(tdir, "textures", names[0]))[..., 3] == 255).all()
    assert stats["texel_uvs"] == 64 * 64 * 2 * 3  # mesh 0's alpha is not evaluated
    assert stats["bytes"] > 0 and stats["eval_s"] > 0 and stats["write_s"] > 0


def test_bake_png_rows_run_from_v0_up(tmp_path):
    """Texel orientation through bake_textures: with textures that output
    their uv, a band PNG holds u along its columns and v up its rows (row 0
    is the texel row at v = 0.5 / res, as OpenGL stores a texture), which
    is the orientation BakedMeshRenderer flips back on load."""
    from types import SimpleNamespace

    class UV(torch.nn.Module):
        def forward(self, uv, bake=False):
            return torch.cat([uv, uv[:, :1]], dim=-1)  # rgb = (u, v, u)

    class Alpha(torch.nn.Module):
        def forward(self, uv, bake=False):
            return uv[:, 1:]

    hp = SimpleNamespace(using_neural_textures=True, are_volsurfs_colors_indep=True,
                         are_volsurfs_alphas_indep=True, sh_degree=0, textures_res=[4],
                         sh_range=[15])
    method = SimpleNamespace(
        device=torch.device("cpu"), hp=hp, nr_meshes=1, solid_inner=False,
        models={"rgb_0": SimpleNamespace(neural_textures=[UV()]),
                "alpha_0": SimpleNamespace(neural_textures=[Alpha()])})
    baker.bake_textures(method, str(tmp_path), batch_size=5)
    img = png.read(str(tmp_path / "textures" / "mesh_0_texture_0_feature_0.png"))
    centres = np.round(255 * (np.arange(4) + 0.5) / 4)
    np.testing.assert_array_equal(img[0, :, 0], centres)  # u along row 0
    np.testing.assert_array_equal(img[:, 0, 1], centres)  # v up the rows
    np.testing.assert_array_equal(img[:, 0, 3], centres)  # alpha = v


def test_scene_json_matches_jax(baked):
    jdir, tdir, jinfo, tinfo, _ = baked
    with open(os.path.join(jdir, "scene.json")) as f:
        ref = json.load(f)
    with open(os.path.join(tdir, "scene.json")) as f:
        got = json.load(f)
    assert sorted(got) == sorted(ref) == ["bg_color", "cameras", "meshes", "resolution",
                                          "sh_degree"]
    assert got["meshes"] == ref["meshes"]
    assert (got["bg_color"], got["sh_degree"], got["resolution"]) == ("white", 1, [32, 32])
    assert got["resolution"] == ref["resolution"]
    assert sorted(got["cameras"]) == sorted(ref["cameras"]) == ["test", "train"]
    for split, cams in ref["cameras"].items():
        assert sorted(got["cameras"][split]) == sorted(cams)
        for cam_id, mats in cams.items():
            assert sorted(got["cameras"][split][cam_id]) == sorted(mats)
            for key, mat in mats.items():
                np.testing.assert_allclose(got["cameras"][split][cam_id][key], mat,
                                           atol=1e-6, rtol=0)


def test_port_baked_scene_renders_alike_in_both_renderers(baked):
    """The scene the port baked, loaded by the JAX package's
    BakedMeshRenderer and by the port's, rendered through ``render`` (both
    trace get_camera_rays' rays unculled) on the two test cameras."""
    _, tdir, _, _, _ = baked
    cams = MVDataset("synthetic", "sphere", "", config=DATA)["test"].cameras
    jcams = JMVDataset("synthetic", "sphere", "", config=DATA)["test"].cameras
    ours = BakedMeshRenderer(tdir, device="cpu")
    theirs = JRenderer(tdir)
    for cam, jcam in zip(cams, jcams):
        got = ours.render(cam)
        ref = np.asarray(theirs.render(jcam))
        assert got.shape == ref.shape == (32, 32, 3)
        hit = np.any(np.abs(ref - 1.0) > 1e-3, axis=-1)
        assert 0.1 < hit.mean() < 0.9
        np.testing.assert_allclose(got, ref, atol=RENDER_ATOL, rtol=0)


def test_bake_textures_needs_cuda_by_default(monkeypatch, tmp_path):
    """bake_textures runs on the method's device; a method that asks for
    CUDA on a host without it raises instead of baking on the CPU."""
    from types import SimpleNamespace

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        baker.bake_textures(SimpleNamespace(device=torch.device("cuda")), str(tmp_path))
