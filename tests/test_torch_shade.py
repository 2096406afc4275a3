"""The plain version of the port's shading (volsurfs_tpu_torch/ops/shade.py,
the CPU path of kernel K4) against the JAX BakedMeshRenderer's
``_sample_bands_mesh`` and ``_shade_mesh``, run op by op, on the same uvs:
texture edges, uvs outside [0, 1], exact texel centres and random points,
for every mesh of the committed scene (mesh 0 ignores alpha) and of a tiny
sh_degree 3 scene written in the test; and its entry on K2's raw buffers
against the plain version on trace_all's dict of the same hits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volsurfs_tpu.renderers.mesh_renderer import BakedMeshRenderer as JaxRenderer
from volsurfs_tpu_torch.datasets import baked_scene
from volsurfs_tpu_torch.datasets.mvdataset import MVDataset
from volsurfs_tpu_torch.ops import bvh as TB
from volsurfs_tpu_torch.ops import shade as SH
from volsurfs_tpu_torch.renderers.mesh_renderer import BakedMeshRenderer, camera_rays

from _baked_uvs import edge_uvs

torch.set_num_threads(2)

# Tolerance: none. The coefficients, rgb and alpha (all float16) must equal
# JAX's bit for bit: the plain version rounds where JAX run op by op rounds.


def _check_scene(jr, tr, res, seed):
    u, v = edge_uvs(res, 3000, seed)
    N = u.shape[0]
    rng = np.random.default_rng(seed + 1)
    d = rng.standard_normal((N, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    hit = rng.uniform(size=N) > 0.1
    uv = np.stack([u, v], -1)
    scene = jr._scene_fast
    for m in range(tr.nr_meshes):
        ref = np.asarray(jr._sample_bands_mesh(scene, m, jnp.asarray(u), jnp.asarray(v)))
        out = SH.sample_bands(tr.band_textures, m, torch.from_numpy(u), torch.from_numpy(v))
        assert out.dtype == torch.float16 and out.shape == ref.shape
        np.testing.assert_array_equal(out.numpy(), ref, err_msg=f"mesh {m} coefficients")

        ref_rgb, ref_alpha = jr._shade_mesh(scene, m, jnp.asarray(uv), jnp.asarray(hit),
                                            jnp.asarray(d))
        rgb, alpha = SH.shade_mesh(tr.band_textures, m, torch.from_numpy(uv),
                                   torch.from_numpy(hit), torch.from_numpy(d), tr.sh_degree,
                                   tr.ignore_alpha[m])
        for name, a, b in (("rgb", rgb, ref_rgb), ("alpha", alpha, ref_alpha)):
            assert a.dtype == torch.float16 and a.shape == b.shape
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"mesh {m} {name}")
        if tr.ignore_alpha[m]:
            assert np.all(alpha.numpy()[hit] == 1.0)
        assert np.all(rgb.numpy()[~hit] == 0.0) and np.all(alpha.numpy()[~hit] == 0.0)


@pytest.fixture(scope="module")
def committed():
    """(JAX renderer, port renderer on the CPU) of the committed scene."""
    return (JaxRenderer(baked_scene.COMMITTED_SCENE),
            BakedMeshRenderer(baked_scene.COMMITTED_SCENE, device="cpu"))


def test_plain_shading_matches_jax_committed_scene(committed):
    """The committed scene: 5 shells, sh_degree 2, bands 512, 256 and 128."""
    jr, tr = committed
    assert tr.ignore_alpha == jr.ignore_alpha == [True, False, False, False, False]
    _check_scene(jr, tr, (512, 256, 128), seed=0)


@pytest.mark.parametrize("max_texture_res", [None, 8])
def test_plain_shading_matches_jax_tiny_sh3_scene(tmp_path, max_texture_res):
    """Two shells at sh_degree 3, bands of 16, 8, 4 and 2 texels (also
    box-downsampled to at most 8), texture_scale (-15, 15), mesh 0 ignoring
    alpha; the textures are loaded as uint8 and their float16 copies agree."""
    res = (16, 8, 4, 2)
    baked_scene.write_random_scene(str(tmp_path), baked_scene.committed_mesh_files()[:2], res, 3,
                                   seed=1)
    jr = JaxRenderer(str(tmp_path), max_texture_res=max_texture_res)
    tr = BakedMeshRenderer(str(tmp_path), max_texture_res=max_texture_res, device="cpu")
    for m in range(2):
        for b in range(4):
            assert np.array_equal(tr.textures_u8[m][b], jr.textures_u8[m][b])
            assert np.array_equal(tr.textures[m][b], jr.textures[m][b])
    _check_scene(jr, tr, res, seed=2)


def test_composite_matches_jax():
    """float16 outer->inner compositing of 5 shells, with a white and a
    black background, bit for bit against JAX ``_composite`` run op by op."""
    jr = JaxRenderer.__new__(JaxRenderer)
    jr.meshes = [None] * 5
    rng = np.random.default_rng(3)
    N = 4096
    rgb = rng.uniform(size=(N, 5, 3)).astype(np.float16)
    alpha = np.where(rng.uniform(size=(N, 5, 1)) < 0.2, 0.0,
                     rng.uniform(size=(N, 5, 1))).astype(np.float16)
    for bg in (1.0, 0.0):
        jr.bg_color = jnp.full(3, bg)
        ref = jr._composite(jnp.asarray(rgb), jnp.asarray(alpha))
        out = SH.composite(torch.from_numpy(rgb), torch.from_numpy(alpha),
                           torch.full((3,), bg))
        for key in ("rgb", "bg_transmittance"):
            assert out[key].shape == ref[key].shape
            np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))


def test_face_uv_table_matches_face_attr(committed):
    """The UV rows K4 reads give TensorMesh.face_attr's interpolation."""
    tr = committed[1]
    rng = np.random.default_rng(4)
    for m, mesh in enumerate(tr.meshes):
        F = mesh.faces.shape[0]
        tri = torch.from_numpy(rng.integers(-1, F, 1000))
        bary = torch.from_numpy(rng.uniform(0, 0.5, (1000, 2)).astype(np.float32))
        ref = mesh.face_attr(mesh.uvs, tri, bary)
        out = SH.interp_uv(tr.face_uv, int(tr.face_offsets[m]), tri, bary)
        assert torch.equal(out, ref)


def _assert_entries_equal(tri, u, v, hits, face_uv, face_offsets, rays_d, r):
    """The raw-buffer entry and the plain version on the dict of the same
    hits give the same rgb and bg_transmittance, bit for bit."""
    rest = (face_uv, face_offsets, rays_d, r.band_textures, r.ignore_alpha_flags, r.bg_color,
            r.sh_degree)
    out = SH.shade_composite_buffers(tri, u, v, *rest)
    ref = SH._shade_composite_reference(hits, *rest)
    for key in ("rgb", "bg_transmittance"):
        assert torch.equal(out[key], ref[key]), key


def test_buffer_entry_equals_dict_entry_committed_frame(committed):
    """K2's buffers of a 64x64 test camera, culled as the frame path culls,
    make trace_all's dict hits, and both shading entries agree bit for
    bit."""
    tr = committed[1]
    cam = MVDataset("synthetic", "sphere", "", splits=("test",),
                    config={"width": 64, "height": 64})["test"].cameras[0]
    it, pt = tr.camera_tensors([cam])
    rays_o, rays_d = camera_rays(it[0], pt[0], 64, 64)
    cull = tr.frame_cull([cam])
    _, tri, u, v = TB.trace_all_buffers(tr.stacked_bvh, rays_o, rays_d, cull)
    hits = TB.trace_all(tr.stacked_bvh, rays_o, rays_d, cull)
    for key, x in SH.hits_from_buffers(tri, u, v, tr.nr_meshes).items():
        assert torch.equal(x, hits[key]), key
    assert 0.05 < float(hits["is_hit"].float().mean()) < 0.95
    _assert_entries_equal(tri, u, v, hits, tr.face_uv, tr.face_offsets, rays_d, tr)


def test_buffer_entry_equals_dict_entry_edges_sh3(tmp_path):
    """The tiny sh_degree 3 scene at uvs on texture edges, outside [0, 1]
    and on texel centres: each hit is face 0 of a one-face UV table whose
    vertex UVs are (0, 0), (1, 0), (0, 1), so that the barycentrics are the
    uv; a fifth of the (shell, ray) pairs miss."""
    res = (16, 8, 4, 2)
    baked_scene.write_random_scene(str(tmp_path), baked_scene.committed_mesh_files()[:2], res, 3,
                                   seed=6)
    r = BakedMeshRenderer(str(tmp_path), device="cpu")
    u, v = edge_uvs(res, 2000, seed=7)
    N = u.shape[0]
    rng = np.random.default_rng(8)
    d = rng.standard_normal((N, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tri = np.where(rng.uniform(size=2 * N) > 0.2, 0, -1).astype(np.int32)
    uu = np.concatenate([u, v]).astype(np.float32)
    vv = np.concatenate([v, u]).astype(np.float32)
    hits = {"is_hit": torch.from_numpy(tri.reshape(2, N) >= 0),
            "triangles_id": torch.from_numpy(tri.reshape(2, N).astype(np.int64)),
            "barycentric": torch.from_numpy(np.stack([uu, vv], -1).reshape(2, N, 2))}
    face_uv = torch.tensor([[0.0, 0.0, 1.0, 0.0, 0.0, 1.0]])
    _assert_entries_equal(torch.from_numpy(tri), torch.from_numpy(uu), torch.from_numpy(vv),
                          hits, face_uv, torch.zeros(2, dtype=torch.int64),
                          torch.from_numpy(d.astype(np.float32)), r)
