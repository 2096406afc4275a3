"""The port's baked-scene renderer (volsurfs_tpu_torch/renderers/) against
the JAX package's, on the CPU: ``render_rays`` on 2,048 rays of a test
camera of the committed scene, ``render_frame`` on a 64x64 camera, and the
numpy pieces beside them (``OrbitCamera``, ``MVDataset("synthetic")``,
``psnr``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volsurfs_tpu.datasets.mvdataset import MVDataset as JaxMVDataset
from volsurfs_tpu.renderers import mesh_renderer as JMR
from volsurfs_tpu.renderers import raster
from volsurfs_tpu.renderers.viewer import OrbitCamera as JaxOrbitCamera
from volsurfs_tpu.utils.evaluation import psnr as jax_psnr
from volsurfs_tpu_torch.datasets import baked_scene
from volsurfs_tpu_torch.datasets.cameras import get_camera_rays
from volsurfs_tpu_torch.datasets.mvdataset import MVDataset
from volsurfs_tpu_torch.ops import bvh as TB
from volsurfs_tpu_torch.ops import shade as SH
from volsurfs_tpu_torch.renderers.mesh_renderer import BakedMeshRenderer, camera_rays
from volsurfs_tpu_torch.renderers.viewer import OrbitCamera
from volsurfs_tpu_torch.utils.evaluation import psnr

torch.set_num_threads(2)

# Tolerances of rgb and bg_transmittance against JAX:
# - run op by op (each jnp op on its own), JAX rounds where the port does;
#   an output may still round one float16 step apart where a float32 SH sum
#   or sigmoid differs in its last bit: 4.9e-4 (a step near 1), on at most
#   0.1% of the entries;
# - jitted, XLA fuses the float16 shading and compositing and keeps float32
#   intermediates (as for the train step's compositing, ROADMAP.md Queue 3):
#   2e-3, a few float16 steps.
OP_BY_OP_ATOL = 4.9e-4
JIT_ATOL = 2e-3


@pytest.fixture(scope="module")
def committed():
    """(JAX renderer, port renderer on the CPU) of the committed scene."""
    return (JMR.BakedMeshRenderer(baked_scene.COMMITTED_SCENE),
            BakedMeshRenderer(baked_scene.COMMITTED_SCENE, device="cpu"))


def _test_camera(res):
    return MVDataset("synthetic", "sphere", "", splits=("test",),
                     config={"width": res, "height": res})["test"].cameras[0]


def test_render_rays_matches_jax(committed, monkeypatch):
    """2,048 rays (every 32nd of a 256x256 test camera) through both
    ``render_rays``: the hits equal JAX ``trace_all``'s bit for bit; rgb and
    bg_transmittance match JAX's ``_render_rays`` run op by op (on the jitted
    trace's hits) and the jitted ``render_rays`` within the tolerances."""
    jr, tr = committed
    rays_o, rays_d = get_camera_rays(_test_camera(256))
    rays_o, rays_d = rays_o[::32].copy(), rays_d[::32].copy()
    o, d = torch.from_numpy(rays_o), torch.from_numpy(rays_d)
    _, tri, u, v = TB.trace_all_buffers(tr.stacked_bvh, o, d)
    hits = SH.hits_from_buffers(tri, u, v, tr.nr_meshes)
    # what render_rays returns, without tracing twice
    out = SH.shade_composite_buffers(tri, u, v, *tr.shade_inputs(hits, d)[1:])
    jhits = jax.jit(JMR.B.trace_all)(jr.stacked_bvh, jnp.asarray(rays_o), jnp.asarray(rays_d))
    for key in ("is_hit", "triangles_id", "barycentric"):
        np.testing.assert_array_equal(hits[key].numpy(), np.asarray(jhits[key]), err_msg=key)
    assert 0.2 < float(hits["is_hit"].float().mean()) < 0.95

    monkeypatch.setattr(JMR.B, "trace_all", lambda *args: jhits)
    op_by_op = jr._render_rays(jr._scene, jnp.asarray(rays_o), jnp.asarray(rays_d))
    monkeypatch.undo()
    jitted = jr.render_rays(jnp.asarray(rays_o), jnp.asarray(rays_d))
    for ref, atol, share in ((op_by_op, OP_BY_OP_ATOL, 1e-3), (jitted, JIT_ATOL, 1.0)):
        for key in ("rgb", "bg_transmittance"):
            a, b = out[key].numpy(), np.asarray(ref[key])
            assert a.shape == b.shape, key
            diff = np.abs(a - b)
            assert diff.max() <= atol, (key, diff.max())
            assert (diff > 0).mean() <= share, (key, (diff > 0).mean())


def _share_an_edge(verts, faces, f0, f1):
    """Whether each pair of faces shares at least two vertex positions (an
    edge; the UV atlas splits vertices along its seams, so indices can
    differ)."""
    a, b = verts[faces[f0]], verts[faces[f1]]  # [n, 3, 3]
    return (a[:, :, None] == b[:, None, :]).all(-1).any(-1).sum(-1) >= 2


def test_render_frame_matches_jax_frame_path(committed):
    """One 64x64 test camera, outside every shell, so both packages cull
    back faces. Hits: the port traces the frame's rays with the shells'
    cull signs, JAX rasterizes them (``raster.tile_rays``, ``bin_triangles``
    with its cull signs and no candidate overflow, ``raster_mesh``). The
    hit masks are equal; a face id may differ only where the two faces share
    an edge (the two frame paths round the ray directions differently, by
    up to one float32 step), on at most 0.1% of the (shell, pixel) pairs.
    rgb: ``render_frame`` against JAX's ``render_frame`` with its defaults,
    within JIT_ATOL wherever every shell's face id agrees."""
    jr, tr = committed
    res = 64
    cam = _test_camera(res)
    assert tr.cameras_outside([cam]) and jr._cameras_outside(cam.pose)
    np.testing.assert_array_equal(tr.cull_signs.numpy(), jr._cull_signs)
    intr = jnp.asarray(cam.intrinsics, jnp.float32)
    c2w = jnp.asarray(cam.pose, jnp.float32)
    w2c = jnp.asarray(np.linalg.inv(cam.pose), jnp.float32)

    @jax.jit
    def raster_faces(intr, c2w, w2c):
        dirs, origin = raster.tile_rays(intr, c2w, res, res)
        faces, overflow = [], 0
        for i, mesh in enumerate(jr.meshes):
            cand, ovf = raster.bin_triangles(mesh.verts, mesh.faces, intr, w2c, res, res, 4096,
                                             cull_sign=jr._cull_signs[i])
            overflow = overflow + jnp.sum(ovf)
            *_, f = raster.raster_mesh(jr._scene_fast["raster_tables"][i], cand, dirs, origin)
            faces.append(raster.tiles_to_image(f[..., None], res, res)[..., 0])
        return jnp.stack(faces).reshape(len(faces), -1), overflow

    jfaces, overflow = raster_faces(intr, c2w, w2c)
    assert int(overflow) == 0
    jfaces = np.asarray(jfaces)
    it, pt = tr.camera_tensors([cam])
    rays_o, rays_d = camera_rays(it[0], pt[0], res, res)
    hits = TB.trace_all(tr.stacked_bvh, rays_o, rays_d, tr.frame_cull([cam]))
    faces = hits["triangles_id"].numpy()
    np.testing.assert_array_equal(faces >= 0, jfaces >= 0)
    differ = faces != jfaces
    assert differ.mean() <= 1e-3, differ.sum()
    for m, (v, f, _) in enumerate(tr.mesh_arrays):
        r = np.nonzero(differ[m])[0]
        assert _share_an_edge(v, f, faces[m, r], jfaces[m, r]).all(), (m, r)

    img = tr.render_frame(cam)
    jimg = jr.render_frame(cam)
    assert img.shape == (res, res, 3) and img.dtype == np.float32
    same = ~differ.any(0).reshape(res, res)
    diff = np.abs(img - jimg)[same]
    assert diff.max() <= JIT_ATOL, diff.max()


def test_frame_entry_points_agree_on_cpu(committed):
    """render() in chunks equals render_rays on get_camera_rays' rays with
    no culling, in one call, as JAX's render traces them;
    render_frames_device's frames equal render_rays on camera_rays' rays
    with the frames' cull signs; no overflow (24x24, few traces)."""
    tr = committed[1]
    cams = MVDataset("synthetic", "sphere", "", splits=("test",),
                     config={"width": 24, "height": 24})["test"].cameras[:2]
    assert tr.cameras_outside(cams)
    imgs, overflow = tr.render_frames_device(cams)
    assert imgs.shape == (2, 24, 24, 3) and overflow.tolist() == [0, 0, 0]
    rays_o, rays_d = (torch.from_numpy(x) for x in get_camera_rays(cams[1]))
    unculled = tr.render_rays(rays_o, rays_d)["rgb"].reshape(24, 24, 3).numpy()
    assert np.array_equal(tr.render(cams[1], chunk_size=300), unculled)
    for i in range(2):
        it, pt = tr.camera_tensors(cams[i:i + 1])
        out = tr.render_rays(*camera_rays(it[0], pt[0], 24, 24), tr.frame_cull(cams[i:i + 1]))
        assert torch.equal(out["rgb"].reshape(24, 24, 3), imgs[i])
        assert out["bg_transmittance"].shape == (24 * 24, 1)
    assert 0.0 < float((imgs[0] != 1.0).any(-1).float().mean()) < 1.0


def test_render_matches_jax(committed):
    """render() of a 32x32 test camera against JAX's render (the traced
    path, no culling) within JIT_ATOL: both take get_camera_rays' rays, and
    JAX's render is jitted."""
    jr, tr = committed
    cam = _test_camera(32)
    img, ref = tr.render(cam, chunk_size=700), jr.render(cam)
    assert img.shape == ref.shape == (32, 32, 3) and img.dtype == np.float32
    diff = np.abs(img - ref)
    assert diff.max() <= JIT_ATOL, diff.max()
    assert 0.0 < float((img != 1.0).any(-1).mean()) < 1.0


def test_orbit_camera_matches_jax():
    """Poses and intrinsics, bit for bit, after rotate, zoom and pan."""
    ours, ref = OrbitCamera(96, 64, radius=2.5), JaxOrbitCamera(96, 64, radius=2.5)
    for step, (da, de, z, pan) in enumerate([(0.0, 0.0, 1.0, (0, 0)), (0.7, 0.2, 0.9, (0.1, 0)),
                                             (2.0, 1.5, 30.0, (0, -0.2)), (-1.0, -3.0, 0.01, (0, 0))]):
        for cam in (ours, ref):
            cam.rotate(da, de)
            cam.zoom(z)
            cam.pan(*pan)
        a, b = ours.camera(), ref.camera()
        assert (a.width, a.height) == (b.width, b.height) == (96, 64)
        np.testing.assert_array_equal(a.intrinsics, b.intrinsics)
        np.testing.assert_array_equal(a.pose, b.pose, err_msg=f"step {step}")


def test_mvdataset_synthetic_matches_jax():
    """Cameras and images of both splits, bit for bit."""
    config = {"width": 24, "height": 16, "nr_train_cameras": 3, "nr_test_cameras": 4}
    ours = MVDataset("synthetic", "sphere", "", config=config)
    ref = JaxMVDataset("synthetic", "sphere", "", config=config)
    assert ours.bg_color == ref.bg_color == "white"
    for split in ("train", "test"):
        a, b = ours[split], ref[split]
        assert len(a.cameras) == len(b.cameras)
        for ca, cb in zip(a.cameras, b.cameras):
            np.testing.assert_array_equal(ca.pose, cb.pose)
            np.testing.assert_array_equal(ca.intrinsics, cb.intrinsics)
            assert (ca.width, ca.height, ca.camera_id) == (cb.width, cb.height, cb.camera_id)
        np.testing.assert_array_equal(a.rgbs, b.rgbs)
        np.testing.assert_array_equal(a.masks, b.masks)
    # a dataset neither package loads (DTU and the blender family are
    # ported now: tests/test_torch_datasets.py)
    with pytest.raises(NotImplementedError):
        MVDataset("llff", "fern", "")
    with pytest.raises(NotImplementedError):
        JaxMVDataset("llff", "fern", "")


def test_psnr_matches_jax():
    rng = np.random.default_rng(0)
    gt = rng.uniform(size=(8, 8, 3)).astype(np.float32)
    pred = gt + rng.normal(0, 0.05, gt.shape).astype(np.float32)
    assert psnr(gt, pred) == jax_psnr(gt, pred)
    assert psnr(gt, gt) == jax_psnr(gt, gt) == 99.0
