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


def assert_hits_match(ref, out):
    """Every output of the two traces equal, bit for bit."""
    ref = {k: torch.from_numpy(np.array(v)) for k, v in ref.items()}
    for key in ("is_hit", "depth", "positions", "barycentric", "triangles_id"):
        assert out[key].shape == ref[key].shape, key
        assert out[key].dtype.is_floating_point == ref[key].dtype.is_floating_point, key
        np.testing.assert_array_equal(out[key].numpy(), ref[key].numpy(), err_msg=key)


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
    packed = TB._pack_nodes(*TB._stacked_arrays(bvhs))
    ref = JB.stack_bvhs([JB.build_bvh(v, f) for v, f, _ in two_meshes])
    np.testing.assert_array_equal(packed.view(np.int32), np.asarray(ref.packed).view(np.int32))
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
    assert_hits_match(ref, out)
    hit_frac = float(out["is_hit"].float().mean())
    assert 0.2 < hit_frac < 0.95, hit_frac


def test_compact_layout_round_trips_packed():
    """K2's device layout holds what the JAX row table holds, bit for bit:
    each inner node's box and skip, each leaf's skip and its real triangles
    and ids in slot order (the -1 pads dropped), on all committed shells."""
    files = sorted(f for f in os.listdir(MESH_DIR) if f.endswith(".obj"))
    meshes = [load_obj(os.path.join(MESH_DIR, f)) for f in files]
    bvhs = [TB.build_bvh(v, f) for v, f, _ in meshes]
    stacked = TB.stack_bvhs(bvhs, "cpu")
    packed = TB._pack_nodes(*TB._stacked_arrays(bvhs))
    nodes, tris = stacked.nodes.numpy(), stacked.tris.numpy()
    L = stacked.leaf_size
    bits = lambda x: np.ascontiguousarray(x).view(np.int32)  # noqa: E731
    is_leaf = packed[:, 0] > 0.5
    np.testing.assert_array_equal(nodes[:, 7], is_leaf.astype(np.float32))
    np.testing.assert_array_equal(bits(nodes[:, 3]), bits(packed[:, 1]))  # skip
    inner = ~is_leaf
    np.testing.assert_array_equal(bits(nodes[inner, 0:3]), bits(packed[inner, 2:5]))
    np.testing.assert_array_equal(bits(nodes[inner, 4:7]), bits(packed[inner, 5:8]))
    leaves = np.nonzero(is_leaf)[0]
    first, count = bits(nodes[leaves, 0]), bits(nodes[leaves, 1])
    ids = bits(packed[leaves, 8 + 9 * L: 8 + 10 * L])  # [leaves, L]
    slot_tris = packed[leaves, 8: 8 + 9 * L].reshape(-1, L, 9)
    real = ids >= 0
    np.testing.assert_array_equal(count, real.sum(axis=1))
    assert (count < L).any() and (count == L).any()
    assert np.all(real == (np.arange(L)[None, :] < count[:, None]))  # pads last
    np.testing.assert_array_equal(first, np.concatenate([[0], np.cumsum(count)[:-1]]))
    assert tris.shape == (int(count.sum()), 12)
    np.testing.assert_array_equal(bits(tris[:, 3]), ids[real])
    mt = np.concatenate([tris[:, 0:3], tris[:, 4:7], tris[:, 8:11]], axis=1)
    np.testing.assert_array_equal(bits(mt), bits(slot_tris[real]))
    assert not tris[:, [7, 11]].any()


def _small_meshes():
    """Two meshes whose leaves hold fewer than 4 triangles. Mesh 0, one
    leaf of 3: a unit triangle at z=0, a collinear one (det 0) on it and a
    1e-5 one at z=0.5 whose det (~1e-10 for a vertical ray) is below 1e-9.
    Mesh 1: a strip of 6 triangles at z=0.25 and a copy of its first one,
    so two faces tie and the first minimum decides."""
    v0 = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0],
                     [0.2, 0.2, 0], [0.4, 0.4, 0], [0.6, 0.6, 0],
                     [0.5, 0.1, 0.5], [0.50001, 0.1, 0.5], [0.5, 0.10001, 0.5]], np.float32)
    f0 = np.arange(9, dtype=np.int32).reshape(3, 3)
    xs = np.linspace(-0.1, 1.1, 4, dtype=np.float32)
    v1 = np.asarray([[x, y, 0.25] for x in xs for y in (-0.1, 1.1)], np.float32)
    quads = [(2 * i, 2 * i + 2, 2 * i + 1, 2 * i + 3) for i in range(3)]
    f1 = np.asarray([t for a, b, c, d in quads for t in ((a, b, c), (c, b, d))], np.int32)
    f1 = np.concatenate([f1, f1[:1]])
    return [(v0, f0), (v1, f1)]


@pytest.mark.parametrize("aim", ["scattered", "at_degenerate_faces"])
def test_trace_all_reference_partial_leaves_and_degenerate_faces_match_jax(aim):
    """The plain trace over K2's layout equals JAX trace_all bit for bit on
    leaves of fewer than 4 triangles, on faces with |det| <= 1e-9, and at
    an exact tie between two copies of one face."""
    meshes = _small_meshes()
    rng = np.random.default_rng(7)
    n = 512
    if aim == "scattered":
        target = np.concatenate([rng.uniform(-0.1, 1.1, (n, 2)), np.zeros((n, 1))], axis=1)
        o = target + np.concatenate([rng.uniform(-0.3, 0.3, (n, 2)), np.full((n, 1), 2.0)], 1)
    else:  # straight down onto the tiny face and along the collinear one
        centre = np.asarray([[0.500003, 0.100003, 0.0], [0.4, 0.4, 0.0], [0.3, 0.3, 0.0]])
        target = centre[rng.integers(0, 3, n)] + rng.uniform(-2e-6, 2e-6, (n, 3)) * [1, 1, 0]
        o = target + [0.0, 0.0, 2.0]
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays_o, rays_d = o.astype(np.float32), d.astype(np.float32)
    stacked = TB.stack_bvhs([TB.build_bvh(v, f) for v, f in meshes], "cpu")
    leaves = stacked.nodes[:, 7] > 0.5
    counts = stacked.nodes[leaves, 1].contiguous().view(torch.int32)
    assert counts[0] == 3 and (counts < stacked.leaf_size).sum() >= 2
    out, work = TB.trace_all_reference(
        stacked, torch.from_numpy(rays_o), torch.from_numpy(rays_d), return_work=True
    )
    leaf_visits = work["node_visits"] - work["box_tests"]
    assert n <= leaf_visits <= work["triangle_tests"]  # mesh 0's root is a leaf
    assert work["max_node_visits"] <= int((stacked.node_end - stacked.node_begin).max())
    # each distinct node and triangle read is counted once
    assert 0 < work["nodes_read"] <= min(stacked.nodes.shape[0], work["node_visits"])
    assert 0 < work["triangles_read"] <= min(stacked.tris.shape[0], work["triangle_tests"])
    ref = JB.trace_all(
        JB.stack_bvhs([JB.build_bvh(v, f) for v, f in meshes]),
        jnp.asarray(rays_o), jnp.asarray(rays_d),
    )
    assert_hits_match(ref, out)
    ids = out["triangles_id"]
    assert not bool((ids[1] == 6).any())  # the copy of face 0 never wins the tie
    if aim == "scattered":
        assert bool((ids[1] == 0).any()) and not bool(out["is_hit"].all())
    else:
        assert bool(out["is_hit"].all())
        assert bool((ids[0] == 0).all())  # neither degenerate face hits


def _closed_cube():
    """A closed cube of side 1 centred at the origin, 12 triangles wound
    with outward normals."""
    v = np.asarray([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)],
                   np.float32)
    faces = []
    for axis in range(3):
        for side in (0, 1):
            quad = [i for i in range(8) if (i >> (2 - axis)) & 1 == side]  # a, b, c, d
            for tri in ((quad[0], quad[1], quad[3]), (quad[0], quad[3], quad[2])):
                a, b, c = v[list(tri)]
                outward = np.dot(np.cross(b - a, c - a), a + b + c) > 0
                faces.append(tri if outward else tri[::-1])
    return v, np.asarray(faces, np.int32)


def test_trace_culls_back_faces(two_meshes):
    """Back-face culling of the plain trace. Cull signs: +1 for the cube
    wound outward, -1 wound inward, and JAX's on the committed shells. Rays
    from outside hit the closed cube exactly as without culling; rays from
    its centre meet only back faces, so they all miss under sign +1 and hit
    as without culling under sign -1; a sign of 0 culls nothing."""
    from volsurfs_tpu.renderers import raster

    v, f = _closed_cube()
    assert TB.mesh_orientation(v, f) == 1 and TB.mesh_orientation(v, f[:, ::-1]) == -1
    for v_, f_, _ in two_meshes:
        assert TB.mesh_orientation(v_, f_) == raster.mesh_orientation(v_, f_)
    stacked = TB.stack_bvhs([TB.build_bvh(v, f)], "cpu")
    rng = np.random.default_rng(11)
    rays_o, rays_d = random_rays(rng, 512)
    o, d = torch.from_numpy(rays_o), torch.from_numpy(rays_d)
    sign = {s: torch.tensor([s], dtype=torch.int32) for s in (-1, 0, 1)}
    plain = TB.trace_all(stacked, o, d)
    assert 0.2 < float(plain["is_hit"].float().mean()) < 1.0
    for cull in (sign[0], sign[1]):
        assert_hits_match(plain, TB.trace_all(stacked, o, d, cull))
    centre = torch.zeros_like(o)
    plain = TB.trace_all(stacked, centre, d)
    assert bool(plain["is_hit"].all())
    assert not bool(TB.trace_all(stacked, centre, d, sign[1])["is_hit"].any())
    assert_hits_match(plain, TB.trace_all(stacked, centre, d, sign[-1]))


def test_trace_buffers_are_the_dict_hits(two_meshes):
    """trace_all_buffers gives the [k*R] buffers that trace_all's dict is
    built from: face ids as int32 (-1 on a miss), u and v, and t where the
    ray hits (inf where it misses), culled and not."""
    rng = np.random.default_rng(12)
    rays_o, rays_d = random_rays(rng, 512)
    o, d = torch.from_numpy(rays_o), torch.from_numpy(rays_d)
    stacked = TB.stack_bvhs([TB.build_bvh(v, f) for v, f, _ in two_meshes], "cpu")
    for cull in (None, torch.tensor([1, -1], dtype=torch.int32)):
        ref = TB.trace_all(stacked, o, d, cull)
        t, tri, u, v = TB.trace_all_buffers(stacked, o, d, cull)
        assert tri.dtype == torch.int32 and t.shape == tri.shape == u.shape == v.shape == (1024,)
        assert torch.equal(tri.reshape(2, 512).long(), ref["triangles_id"])
        assert torch.equal(torch.stack([u, v], -1).reshape(2, 512, 2), ref["barycentric"])
        hit = ref["is_hit"].reshape(-1)
        assert torch.equal(t[hit], ref["depth"].reshape(-1)[hit])
        assert bool(torch.isinf(t[~hit]).all()) and 0.1 < float(hit.float().mean()) < 0.95


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
