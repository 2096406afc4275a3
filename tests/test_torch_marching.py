"""The port's mesh baking modules against volsurfs_tpu's on the CPU:
marching tetrahedra (analytic sphere, a seeded random field, a field with
exact zeros on its nodes, an empty field at 24^3-40^3: the same faces in
the same order, vertices within 1e-6), ``post_process_mesh``,
``fuse_depths`` (32^3, depth maps of a sphere seen from seeded cameras),
``simplify_mesh`` (the same native source: equal arrays) and
``compute_atlas`` (a copy: uvs within 1e-9)."""

import numpy as np
import pytest
import torch

from volsurfs_tpu.baking import marching as JM
from volsurfs_tpu.baking import simplify as JSimp
from volsurfs_tpu.baking import tsdf as JT
from volsurfs_tpu.baking import uv_atlas as JA
from volsurfs_tpu_torch.baking import marching as M
from volsurfs_tpu_torch.baking import simplify as Simp
from volsurfs_tpu_torch.baking import tsdf as T
from volsurfs_tpu_torch.baking import uv_atlas as A
from volsurfs_tpu_torch.datasets.cameras import get_camera_rays
from volsurfs_tpu_torch.datasets.synthetic import make_synthetic_split

VERT_ATOL = 1e-6


def _field(kind, n):
    rng = np.random.default_rng(n)
    lin = np.linspace(-1.0, 1.0, n)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    if kind == "sphere":
        return (np.sqrt(x**2 + y**2 + z**2) - 0.6).astype(np.float32)
    if kind == "random":
        return rng.standard_normal((n, n, n)).astype(np.float32)
    if kind == "zeros_on_nodes":  # integers: many nodes exactly on the level
        return np.round(rng.standard_normal((n, n, n)) * 1.5).astype(np.float32)
    return np.ones((n, n, n), np.float32)  # empty


def _assert_same_mesh(got, ref):
    (gv, gf), (rv, rf) = got, ref
    assert gv.dtype == rv.dtype == np.float32 and gf.dtype == rf.dtype == np.int32
    np.testing.assert_array_equal(gf, rf)
    assert gv.shape == rv.shape
    if len(rv):
        np.testing.assert_allclose(gv, rv, rtol=0, atol=VERT_ATOL)


@pytest.mark.parametrize("n", [24, 33, 40])
@pytest.mark.parametrize("kind", ["sphere", "random", "zeros_on_nodes", "empty"])
def test_marching_tetrahedra_matches_jax(kind, n):
    values = _field(kind, n)
    origin = np.full(3, -1.0)
    spacing = np.full(3, 2.0 / (n - 1))
    ref = JM.marching_tetrahedra(values, origin, spacing)
    _assert_same_mesh(M.marching_tetrahedra(torch.from_numpy(values), origin, spacing), ref)
    _assert_same_mesh(M.marching_tetrahedra(values, origin, spacing, device="cpu"), ref)
    assert (len(ref[1]) == 0) == (kind == "empty")


def test_extract_mesh_from_fn_matches_jax():
    """A field callable on the grid (chunked), at a level != 0."""
    def field(p):
        p = np.asarray(p, np.float32)
        return np.linalg.norm(p, axis=-1) - np.float32(0.5) + np.float32(0.1) * np.sin(7 * p[:, 0])

    ref = JM.extract_mesh_from_fn(field, 30, 1.0, chunk=4096, level=0.05)
    got = M.extract_mesh_from_fn(lambda p: torch.from_numpy(field(p.numpy())), 30, 1.0,
                                 chunk=4096, level=0.05, device="cpu")
    _assert_same_mesh(got, ref)


def test_post_process_mesh_matches_jax():
    v, f = JM.marching_tetrahedra(_field("random", 24), np.full(3, -1.0),
                                  np.full(3, 2.0 / 23))
    for keep, min_tris in ((1000, 50), (3, 5)):
        ref = JM.post_process_mesh(v, f, keep, min_tris)
        got = M.post_process_mesh(v, f, keep, min_tris)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])


def _sphere_depths(n_cams=6, size=24, radius=0.5):
    """z-depth maps of a sphere at the origin seen from seeded cameras
    (0 where the ray misses)."""
    cams, _, _ = make_synthetic_split(n_cams, size, size, cam_radius=2.0, sphere_radius=radius,
                                      seed=3)
    depths = []
    for cam in cams:
        o, d = get_camera_rays(cam)
        o, d = o.astype(np.float64), d.astype(np.float64)
        b = np.sum(o * d, -1)
        disc = b**2 - (np.sum(o * o, -1) - radius**2)
        t = np.where(disc > 0, -b - np.sqrt(np.maximum(disc, 0)), 0.0)
        forward = cam.pose[:3, 2]
        depths.append((t * (d @ forward)).reshape(size, size).astype(np.float32))
    return depths, cams


def test_fuse_depths_matches_jax():
    depths, cams = _sphere_depths()
    ref = JT.fuse_depths(depths, cams, resolution=32, bounds=1.0)
    got = T.fuse_depths(depths, cams, resolution=32, bounds=1.0, device="cpu")
    assert len(ref[1]) > 100
    _assert_same_mesh(got, ref)


def _sphere_mesh(n=40):
    return JM.marching_tetrahedra(_field("sphere", n), np.full(3, -1.0), np.full(3, 2.0 / (n - 1)))


def test_simplify_mesh_matches_jax():
    v, f = _sphere_mesh()
    for ratio in (0.025, 0.3):
        ref = JSimp.simplify_mesh(v, f, ratio)
        got = Simp.simplify_mesh(v, f, ratio)
        assert got[0].dtype == np.float32 and got[1].dtype == np.int32
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert 4 <= len(got[1]) < len(f)


def test_compute_atlas_matches_jax():
    v, f = JSimp.simplify_mesh(*_sphere_mesh(), 0.1)
    ref = JA.compute_atlas(v, f)
    got = A.compute_atlas(v, f)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=1e-9)
    assert got[2].min() >= 0.0 and got[2].max() <= 1.0
