"""Parity of the torch port's BVH (host build and the plain trace) with the
JAX package's ops/bvh.py on committed mesh shells."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volsurfs_tpu.baking.mesh_io import load_obj as jax_load_obj
from volsurfs_tpu.ops import bvh as JB
from volsurfs_tpu_torch.baking.mesh_io import load_obj
from volsurfs_tpu_torch.ops import bvh as TB

torch.set_num_threads(2)

MESH_DIR = os.path.join(
    os.path.dirname(__file__), "..", "runs", "pipeline_tpu_256", "volsurfs", "meshes"
)


def random_rays(rng, n, radius=2.0, spread=0.6):
    """Rays from a sphere of the given radius towards points near the origin."""
    o = rng.standard_normal((n, 3))
    o = radius * o / np.linalg.norm(o, axis=-1, keepdims=True)
    target = rng.uniform(-spread, spread, (n, 3))
    d = target - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def assert_hits_match(meshes, ref, out, rays_o, rays_d):
    """is_hit exact; depth and barycentrics within 1e-5; triangle ids exact
    except where the port's face, tested again on its own, meets the ray
    within 1e-6 of JAX's depth (two faces tie)."""
    ref = {k: torch.from_numpy(np.array(v)) for k, v in ref.items()}
    for key in ("is_hit", "depth", "positions", "barycentric", "triangles_id"):
        assert out[key].shape == ref[key].shape, key
    np.testing.assert_array_equal(out["is_hit"].numpy(), ref["is_hit"].numpy())
    for key in ("depth", "barycentric", "positions"):
        np.testing.assert_allclose(out[key].numpy(), ref[key].numpy(), atol=1e-5, rtol=0,
                                   err_msg=key)
    meshes = [(v, f) for v, f, _ in meshes]
    assert TB.face_id_mismatches(
        meshes, out, ref, torch.from_numpy(rays_o), torch.from_numpy(rays_d)
    ) == 0


@pytest.fixture(scope="module")
def two_meshes():
    return [load_obj(os.path.join(MESH_DIR, f"{i}.obj")) for i in (0, 4)]


def test_load_obj_matches_jax(two_meshes):
    ref = jax_load_obj(os.path.join(MESH_DIR, "0.obj"))
    for a, b in zip(two_meshes[0], ref):
        np.testing.assert_array_equal(a, b)


def test_stacked_packed_bvh_equals_jax(two_meshes):
    bvhs = [TB.build_bvh(v, f) for v, f, _ in two_meshes]
    stacked = TB.stack_bvhs(bvhs, "cpu")
    ref = JB.stack_bvhs([JB.build_bvh(v, f) for v, f, _ in two_meshes])
    np.testing.assert_array_equal(
        stacked.packed.numpy().view(np.int32), np.asarray(ref.packed).view(np.int32)
    )
    np.testing.assert_array_equal(stacked.node_begin.numpy(), np.asarray(ref.node_begin))
    np.testing.assert_array_equal(stacked.node_end.numpy(), np.asarray(ref.node_end))


def test_trace_all_reference_matches_jax(two_meshes):
    rng = np.random.default_rng(0)
    rays_o, rays_d = random_rays(rng, 2048)
    stacked = TB.stack_bvhs([TB.build_bvh(v, f) for v, f, _ in two_meshes], "cpu")
    out = TB.trace_all(stacked, torch.from_numpy(rays_o), torch.from_numpy(rays_d))
    ref = JB.trace_all(
        JB.stack_bvhs([JB.build_bvh(v, f) for v, f, _ in two_meshes]),
        jnp.asarray(rays_o), jnp.asarray(rays_d),
    )
    assert_hits_match(two_meshes, ref, out, rays_o, rays_d)
    hit_frac = float(out["is_hit"].float().mean())
    assert 0.2 < hit_frac < 0.95, hit_frac


def test_face_id_rule_excuses_only_ties(two_meshes):
    """The tie rule of the trace checks: a face id moved to a neighbour
    slot is counted, the trace's own ids are not, and a second face at the
    same depth is excused."""
    rng = np.random.default_rng(3)
    rays_o, rays_d = random_rays(rng, 512)
    o, d = torch.from_numpy(rays_o), torch.from_numpy(rays_d)
    stacked = TB.stack_bvhs([TB.build_bvh(v, f) for v, f, _ in two_meshes], "cpu")
    ref = TB.trace_all(stacked, o, d)
    meshes = [(v, f) for v, f, _ in two_meshes]
    assert TB.face_id_mismatches(meshes, ref, ref, o, d) == 0
    wrong = dict(ref)
    tri = ref["triangles_id"]
    wrong["triangles_id"] = torch.where(tri >= 0, (tri + 1) % len(meshes[0][1]), tri)
    assert TB.face_id_mismatches(meshes, wrong, ref, o, d) >= int(ref["is_hit"].sum()) // 2
    # the same triangle twice in one mesh: either copy is a tie
    v, f = meshes[0]
    doubled = [(v, np.concatenate([f, f]))]
    first = {k: x[:1] for k, x in ref.items()}
    second = dict(first)
    second["triangles_id"] = torch.where(first["triangles_id"] >= 0,
                                         first["triangles_id"] + len(f), -1)
    assert TB.face_id_mismatches(doubled, second, first, o, d) == 0


def test_face_attr_and_normals_match_jax(two_meshes):
    v, f, uv = two_meshes[0]
    rng = np.random.default_rng(1)
    face_ids = rng.integers(-1, f.shape[0], 300)
    bary = rng.uniform(0.0, 0.5, (300, 2)).astype(np.float32)
    mesh = TB.make_tensor_mesh(v, f, uv, device="cpu")
    ref_mesh = JB.make_tensor_mesh(v, f, uv)
    np.testing.assert_allclose(mesh.normals.numpy(), np.asarray(ref_mesh.normals), atol=1e-6)
    out = mesh.face_attr(mesh.uvs, torch.from_numpy(face_ids), torch.from_numpy(bary))
    ref = ref_mesh.face_attr(ref_mesh.uvs, jnp.asarray(face_ids), jnp.asarray(bary))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_build_bvh_rejects_bad_faces():
    verts = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        TB.build_bvh(verts, np.asarray([[0, 1, 3]], np.int32))


def test_bounding_sphere_intersect_matches_jax():
    from volsurfs_tpu.ops import raycast as JR
    from volsurfs_tpu_torch.ops import raycast as TR

    rng = np.random.default_rng(2)
    rays_o, rays_d = random_rays(rng, 512, radius=1.5, spread=1.5)
    rays_o[:64] *= 0.1  # some rays start inside the sphere
    ref = JR.intersect_bounding_primitive(
        JR.make_bounding_sphere(1.0), jnp.asarray(rays_o), jnp.asarray(rays_d)
    )
    out = TR.intersect_bounding_primitive(
        TR.make_bounding_sphere(1.0), torch.from_numpy(rays_o), torch.from_numpy(rays_d)
    )
    np.testing.assert_array_equal(out["is_hit"].numpy(), np.asarray(ref["is_hit"]))
    for key in ("t_near", "t_far", "points_near", "points_far"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-6, err_msg=key)
