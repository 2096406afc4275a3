"""Iso-surface extraction by marching tetrahedra on the device (counterpart
of volsurfs_tpu/baking/marching.py, which does it in host numpy).

Each grid cube is split into 6 tetrahedra sharing its main diagonal; the
zero crossings on the tetrahedra's edges are interpolated and welded by
their grid edge, so the mesh is watertight wherever the field is.

``marching_tetrahedra`` runs as torch ops on the device of its values, in
float64 as the numpy version does, and returns the numpy version's arrays
(the same faces in the same order, the same vertices). It first keeps the
cubes whose corners lie on both sides of the level (a tetrahedron of any
other cube has no crossing), so at 256^3 it expands ~10^5 cubes into
tetrahedra where the numpy version expands all 16.6M (99.5M tetrahedra).
``extract_mesh_from_fn`` evaluates the field on a dense grid in chunks on
the device and marches it there; ``evaluate_grid`` gives the grid values
of a field with several outputs, which the baker marches one column at a
time. ``post_process_mesh`` is host numpy, a copy of the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from volsurfs_tpu_torch.methods.volsurfs import resolve_device

# 6 tetrahedra per cube, as corner indices of the cube (0..7, bit order xyz:
# corner c has offset (c&1, (c>>1)&1, (c>>2)&1)). All share the main diagonal
# 0-7 so faces of adjacent tets match.
_CUBE_TETS = np.asarray(
    [[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]],
    np.int64,
)

# tet edges as pairs of local vertex ids
_TET_EDGES = np.asarray([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64)

# triangle table: for each of the 16 sign cases (bit i set = vertex i inside,
# i.e. sdf < 0), the triangles as triples of tet-edge ids (-1 padded, max 2).
# Orientation is fixed afterwards against the field gradient.
_TRI_TABLE = -np.ones((16, 2, 3), np.int64)


def _fill_tri_table():
    # single-vertex cases: one triangle on the three edges touching the vertex
    vertex_edges = {0: [0, 1, 2], 1: [0, 3, 4], 2: [1, 3, 5], 3: [2, 4, 5]}
    for v, edges in vertex_edges.items():
        _TRI_TABLE[1 << v, 0] = edges  # vertex inside
        _TRI_TABLE[15 ^ (1 << v), 0] = edges[::-1]  # vertex outside, others inside
    # two-vertex cases: quad on the four crossing edges -> two triangles
    pair_quads = {
        (0, 1): [1, 2, 4, 3],
        (0, 2): [0, 3, 5, 2],
        (0, 3): [0, 4, 5, 1],
        (1, 2): [0, 1, 5, 4],
        (1, 3): [0, 2, 5, 3],
        (2, 3): [1, 3, 4, 2],
    }
    for (a, b), quad in pair_quads.items():
        case = (1 << a) | (1 << b)
        _TRI_TABLE[case, 0] = [quad[0], quad[1], quad[2]]
        _TRI_TABLE[case, 1] = [quad[0], quad[2], quad[3]]
        inv = 15 ^ case
        _TRI_TABLE[inv, 0] = [quad[2], quad[1], quad[0]]
        _TRI_TABLE[inv, 1] = [quad[3], quad[2], quad[0]]


_fill_tri_table()


def _gradient_at(values, ix, iy, iz, spacing):
    """np.gradient(values, *spacing) (edge_order 1) at the nodes (ix, iy,
    iz) only: central differences inside, one-sided at the faces, each
    divided as numpy divides. Returns [F, 3]."""
    out = []
    idx = [ix, iy, iz]
    for axis in range(3):
        n = values.shape[axis]
        i = idx[axis]
        lo, hi = torch.clamp(i - 1, min=0), torch.clamp(i + 1, max=n - 1)
        at = list(idx)
        at[axis] = hi
        f_hi = values[tuple(at)]
        at[axis] = lo
        f_lo = values[tuple(at)]
        inner = (i > 0) & (i < n - 1)
        d = float(spacing[axis])
        out.append(torch.where(inner, (f_hi - f_lo) / (2.0 * d), (f_hi - f_lo) / d))
    return torch.stack(out, dim=-1)


def marching_tetrahedra(values, origin, spacing, device=None):
    """Extract the zero level set of a dense scalar grid.

    Args:
      values: [nx, ny, nz] field (sdf-like; negative = inside), a tensor
        (marched on its device) or an array (marched on ``device``).
      origin: [3] world position of grid node (0,0,0).
      spacing: [3] world distance between grid nodes.
      device: where an array's values are marched (default cuda).
    Returns:
      (vertices [V, 3] float32, faces [F, 3] int32) numpy arrays, with
      triangle normals oriented along the field gradient (outward for an
      SDF).
    """
    if isinstance(values, torch.Tensor):
        dev = values.device if device is None else resolve_device(device)
    else:
        dev = resolve_device("cuda" if device is None else device)
    values = torch.as_tensor(values).to(dev, torch.float64)
    nx, ny, nz = values.shape
    origin = np.asarray(origin, np.float64)
    spacing = np.asarray(spacing, np.float64)
    empty = np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    if min(nx, ny, nz) < 2:
        return empty

    # the cubes with corners on both sides of the level, in the numpy
    # version's (x, y, z) order
    inside = values < 0.0
    count = sum(inside[(c & 1):nx - 1 + (c & 1), ((c >> 1) & 1):ny - 1 + ((c >> 1) & 1),
                       ((c >> 2) & 1):nz - 1 + ((c >> 2) & 1)].to(torch.int8) for c in range(8))
    cubes = torch.nonzero(((count > 0) & (count < 8)).reshape(-1)).reshape(-1)
    if cubes.numel() == 0:
        return empty
    bz = cubes % (nz - 1)
    by = (cubes // (nz - 1)) % (ny - 1)
    bx = cubes // ((nz - 1) * (ny - 1))

    def node_id(ix, iy, iz):
        return (ix * ny + iy) * nz + iz

    corner_ids = torch.stack([node_id(bx + (c & 1), by + ((c >> 1) & 1), bz + ((c >> 2) & 1))
                              for c in range(8)], dim=1)  # [C, 8]
    flat_vals = values.reshape(-1)
    tets = corner_ids[:, torch.from_numpy(_CUBE_TETS).to(dev)].reshape(-1, 4)  # [C*6, 4]
    tet_vals = flat_vals[tets]
    tin = (tet_vals < 0.0).to(torch.int64)
    case = tin[:, 0] | (tin[:, 1] << 1) | (tin[:, 2] << 2) | (tin[:, 3] << 3)
    active = (case != 0) & (case != 15)
    tets, case = tets[active], case[active]
    if tets.shape[0] == 0:
        return empty

    # gather triangles (edge ids) per active tet
    tris_e = torch.from_numpy(_TRI_TABLE).to(dev)[case]  # [T, 2, 3]
    t_idx, tri_idx = torch.nonzero(tris_e[:, :, 0] >= 0, as_tuple=True)
    tri_edges = tris_e[t_idx, tri_idx]  # [F, 3] edge ids in their tets
    ev = torch.from_numpy(_TET_EDGES).to(dev)[tri_edges]  # [F, 3, 2] local vertex ids
    tet_nodes = tets[t_idx]  # [F, 4]
    n0 = torch.gather(tet_nodes, 1, ev[..., 0])
    n1 = torch.gather(tet_nodes, 1, ev[..., 1])

    # weld by undirected grid edge key
    n_nodes = nx * ny * nz
    edge_key = torch.minimum(n0, n1) * n_nodes + torch.maximum(n0, n1)
    unique_keys, inverse = torch.unique(edge_key.reshape(-1), sorted=True, return_inverse=True)
    faces = inverse.reshape(-1, 3)

    # interpolate vertex positions on unique edges
    u_lo, u_hi = unique_keys // n_nodes, unique_keys % n_nodes
    v_lo, v_hi = flat_vals[u_lo], flat_vals[u_hi]
    diff = v_lo - v_hi
    t = torch.clamp(v_lo / torch.where(torch.abs(diff) < 1e-12, 1e-12, diff), 0.0, 1.0)
    origin_t = torch.from_numpy(origin).to(dev)
    spacing_t = torch.from_numpy(spacing).to(dev)

    def node_pos(ids):
        iz = ids % nz
        iy = (ids // nz) % ny
        ix = ids // (nz * ny)
        return origin_t[None] + torch.stack([ix, iy, iz], -1).to(torch.float64) * spacing_t[None]

    p_lo = node_pos(u_lo)
    verts = p_lo + t[:, None] * (node_pos(u_hi) - p_lo)

    # drop degenerate faces (edges on the same grid edge)
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    faces = faces[ok]

    # orient triangles along the field gradient (outward for an SDF)
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    centers = (a + b + c) / 3.0
    idx = torch.round((centers - origin_t) / spacing_t).to(torch.int64)
    idx = torch.minimum(torch.clamp(idx, min=0),
                        torch.tensor([nx - 1, ny - 1, nz - 1], device=dev))
    g = _gradient_at(values, idx[:, 0], idx[:, 1], idx[:, 2], spacing)
    e1, e2 = b - a, c - a
    n = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                     e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                     e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], dim=-1)
    flip = (n[:, 0] * g[:, 0] + n[:, 1] * g[:, 1] + n[:, 2] * g[:, 2]) < 0.0
    faces = torch.where(flip[:, None], faces[:, [0, 2, 1]], faces)
    return (verts.to(torch.float32).cpu().numpy(),
            faces.to(torch.int32).cpu().numpy())


def grid_points(resolution: int, bounds: float, device="cuda"):
    """The grid nodes [resolution^3, 3] (float32, x slowest) spanning
    [-bounds, bounds]^3, on the device, as the numpy version lays them."""
    lin = torch.from_numpy(np.linspace(-bounds, bounds, resolution, dtype=np.float32))
    lin = lin.to(resolve_device(device))
    axes = torch.meshgrid(lin, lin, lin, indexing="ij")
    return torch.stack(axes, dim=-1).reshape(-1, 3)


def evaluate_grid(fn, resolution: int, bounds: float, chunk: int = 65536, device="cuda"):
    """fn ([n, 3] points on the device -> [n] or [n, K] values) on the
    grid of ``grid_points``, chunk points a call: [res, res, res(, K)]
    float32 on the device."""
    pts = grid_points(resolution, bounds, device)
    with torch.no_grad():
        out = torch.cat([fn(pts[i:i + chunk]).to(torch.float32)
                         for i in range(0, pts.shape[0], chunk)])
    return out.reshape((resolution,) * 3 + tuple(out.shape[1:]))


def grid_origin_spacing(resolution: int, bounds: float):
    """(origin [3], spacing [3]) float64 of the grid of ``grid_points``."""
    return (np.full(3, -bounds, np.float64),
            np.full(3, 2.0 * bounds / (resolution - 1), np.float64))


def extract_mesh_from_fn(sdf_fn, resolution: int = 128, bounds: float = 1.0,
                         chunk: int = 65536, level: float = 0.0, device="cuda"):
    """Evaluate an SDF callable on a dense grid (chunked, on the device)
    and extract the ``level`` set (level != 0 extracts offset shells).

    Args:
      sdf_fn: [N, 3] tensor on the device -> [N] or [N, 1] values.
    Returns (verts [V, 3] float32, faces [F, 3] int32) numpy arrays.
    """
    values = evaluate_grid(lambda p: sdf_fn(p).reshape(-1), resolution, bounds, chunk, device)
    origin, spacing = grid_origin_spacing(resolution, bounds)
    return marching_tetrahedra(values - level, origin, spacing)


def post_process_mesh(verts, faces, cluster_to_keep: int = 1000, min_triangles: int = 50):
    """Filter floaters / disconnected parts from an extracted mesh: cluster
    connected triangles, keep the ``cluster_to_keep`` largest clusters but
    never clusters below ``min_triangles`` faces, then drop unreferenced
    vertices (host numpy union-find over shared vertices).

    Returns (verts', faces') with faces reindexed.
    """
    verts = np.asarray(verts)
    faces = np.asarray(faces, np.int64)
    if len(faces) == 0:
        return verts, faces

    parent = np.arange(len(verts), dtype=np.int64)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    for f in faces:
        ra, rb, rc = find(f[0]), find(f[1]), find(f[2])
        parent[rb] = ra
        parent[rc] = ra
    roots = np.asarray([find(v) for v in faces[:, 0]])

    labels, counts = np.unique(roots, return_counts=True)
    order = np.argsort(-counts)
    thresh = counts[order[cluster_to_keep - 1]] if len(order) > cluster_to_keep else 0
    thresh = max(thresh, min_triangles)
    keep_labels = set(labels[counts >= thresh].tolist())
    if not keep_labels:  # degenerate: everything smaller than min_triangles
        keep_labels = {labels[order[0]]}
    keep = np.asarray([r in keep_labels for r in roots])
    faces = faces[keep]

    used = np.unique(faces)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces]
