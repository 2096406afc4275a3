"""UV atlas generation: charting + LSCM parameterization + packing (a copy
of volsurfs_tpu/baking/uv_atlas.py, which cannot be imported without JAX;
host numpy and scipy). Pipeline:

1. split faces into charts by normal-deviation region growing,
2. flatten each chart with LSCM (least-squares conformal map; two pinned
   vertices, sparse least squares via scipy),
3. normalize chart scale to world size (texel density roughly uniform),
4. shelf-pack chart bounding boxes into the unit square with gutters.

Vertices on chart boundaries are duplicated per chart (wedge UVs), as
xatlas produces them. scipy is required: without it the import raises.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def face_normals(verts, faces):
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    n = np.cross(e1, e2)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


def _face_adjacency(faces):
    """list of (f, g) pairs sharing an edge."""
    edges = {}
    adj = [[] for _ in range(faces.shape[0])]
    for f, tri in enumerate(faces):
        for k in range(3):
            a, b = tri[k], tri[(k + 1) % 3]
            key = (min(a, b), max(a, b))
            if key in edges:
                g = edges[key]
                adj[f].append(g)
                adj[g].append(f)
            else:
                edges[key] = f
    return adj


def grow_charts(verts, faces, normal_thresh: float = 0.6, max_chart_faces: int = 4000):
    """Region-grow charts of faces with similar normals.

    Returns: chart id per face [F].
    """
    F = faces.shape[0]
    normals = face_normals(verts, faces)
    adj = _face_adjacency(faces)
    chart = -np.ones(F, np.int32)
    cid = 0
    order = np.argsort(-np.abs(normals[:, 2]))  # deterministic seed order
    for seed in order:
        if chart[seed] >= 0:
            continue
        stack = [int(seed)]
        chart[seed] = cid
        seed_n = normals[seed].copy()
        count = 1
        while stack:
            f = stack.pop()
            for g in adj[f]:
                if chart[g] >= 0 or count >= max_chart_faces:
                    continue
                if np.dot(normals[g], seed_n) > normal_thresh:
                    chart[g] = cid
                    stack.append(g)
                    count += 1
        cid += 1
    return chart


def lscm(verts, faces):
    """Least-squares conformal parameterization of one chart.

    verts: [V, 3] chart vertices; faces: [F, 3] local indices.
    Returns uv [V, 2].
    """
    V = verts.shape[0]
    if V < 3 or faces.shape[0] == 0:
        return np.zeros((V, 2), np.float64)

    # pin the two most distant vertices (approximation: extremes along the
    # largest-variance axis)
    centered = verts - verts.mean(0)
    axis = np.argmax(centered.var(0))
    p0 = int(np.argmin(centered[:, axis]))
    p1 = int(np.argmax(centered[:, axis]))
    if p0 == p1:
        p1 = (p0 + 1) % V

    # local orthonormal frame per face; LSCM energy rows
    rows, cols, vals_r, vals_i = [], [], [], []
    for f, tri in enumerate(faces):
        p = verts[tri]
        e1 = p[1] - p[0]
        e2 = p[2] - p[0]
        n = np.cross(e1, e2)
        a = np.linalg.norm(n)
        if a < 1e-16:
            continue
        x_ax = e1 / max(np.linalg.norm(e1), 1e-16)
        n_ax = n / a
        y_ax = np.cross(n_ax, x_ax)
        # 2D coords of the triangle
        q = np.stack(
            [np.array([0.0, 0.0]),
             np.array([np.dot(e1, x_ax), 0.0]),
             np.array([np.dot(e2, x_ax), np.dot(e2, y_ax)])]
        )
        dT = 2.0 * 0.5 * abs(
            (q[1, 0] - q[0, 0]) * (q[2, 1] - q[0, 1])
            - (q[2, 0] - q[0, 0]) * (q[1, 1] - q[0, 1])
        )
        if dT < 1e-16:
            continue
        s = 1.0 / np.sqrt(dT)
        # W_j = (x_{j+2} - x_{j+1}) + i (y_{j+2} - y_{j+1})
        for j in range(3):
            wr = (q[(j + 2) % 3, 0] - q[(j + 1) % 3, 0]) * s
            wi = (q[(j + 2) % 3, 1] - q[(j + 1) % 3, 1]) * s
            rows.append(f)
            cols.append(int(tri[j]))
            vals_r.append(wr)
            vals_i.append(wi)

    nF = faces.shape[0]
    Mr = sp.coo_matrix((vals_r, (rows, cols)), shape=(nF, V)).tocsr()
    Mi = sp.coo_matrix((vals_i, (rows, cols)), shape=(nF, V)).tocsr()

    free = np.asarray([v for v in range(V) if v not in (p0, p1)], np.int64)
    pinned = np.asarray([p0, p1], np.int64)
    # pinned uvs: (0,0) and (1,0)
    up = np.asarray([[0.0, 0.0], [1.0, 0.0]])

    # complex LSCM system as a real block system:
    # rows: [Mr -Mi; Mi Mr] [u; v] = 0
    A = sp.bmat(
        [[Mr[:, free], -Mi[:, free]], [Mi[:, free], Mr[:, free]]]
    ).tocsr()
    Bp = sp.bmat(
        [[Mr[:, pinned], -Mi[:, pinned]], [Mi[:, pinned], Mr[:, pinned]]]
    ).tocsr()
    b = -Bp @ np.concatenate([up[:, 0], up[:, 1]])

    if free.size:
        sol = spla.lsqr(A, b, atol=1e-10, btol=1e-10)[0]
        u = np.zeros(V)
        v = np.zeros(V)
        u[free] = sol[: free.size]
        v[free] = sol[free.size :]
    else:
        u = np.zeros(V)
        v = np.zeros(V)
    u[p0], v[p0] = up[0]
    u[p1], v[p1] = up[1]
    return np.stack([u, v], -1)


def pack_charts(chart_uvs, chart_world_areas, gutter: float = 0.005):
    """Scale charts to uniform texel density and shelf-pack their boxes.

    Args:
      chart_uvs: list of [Vc, 2] per-chart uvs.
      chart_world_areas: list of world-space surface areas (for density).
    Returns list of transformed uvs packed in [0, 1]^2.
    """
    boxes = []
    scaled = []
    for uv, area in zip(chart_uvs, chart_world_areas):
        lo = uv.min(0)
        hi = uv.max(0)
        size = np.maximum(hi - lo, 1e-9)
        uv_area = max(size[0] * size[1], 1e-12)
        # scale so chart uv area ~ world area (uniform density)
        scale = np.sqrt(max(area, 1e-12) / uv_area)
        uvn = (uv - lo) * scale
        scaled.append(uvn)
        boxes.append(uvn.max(0) + gutter)
    # normalize total scale so everything fits ~unit square
    total_area = sum(b[0] * b[1] for b in boxes)
    norm = 1.0 / np.sqrt(max(total_area * 1.4, 1e-12))
    scaled = [uv * norm for uv in scaled]
    boxes = [b * norm for b in boxes]

    # shelf packing, tallest first
    order = np.argsort([-b[1] for b in boxes])
    placed = [None] * len(boxes)
    x = y = shelf_h = 0.0
    for i in order:
        w, h = boxes[i]
        if x + w > 1.0 and x > 0.0:
            y += shelf_h
            x = 0.0
            shelf_h = 0.0
        placed[i] = (x, y)
        x += w
        shelf_h = max(shelf_h, h)
    height = y + shelf_h
    out = []
    for i, uv in enumerate(scaled):
        ox, oy = placed[i]
        uvp = uv + np.asarray([ox, oy])
        if height > 1.0:
            uvp = uvp / height
        out.append(uvp)
    return out


def compute_atlas(verts: np.ndarray, faces: np.ndarray):
    """Full atlas: charts -> LSCM -> packing, with per-chart vertex splits.

    Returns (new_verts [V', 3], new_faces [F, 3], uvs [V', 2]).
    """
    if faces.shape[0] == 0:
        return (
            verts.astype(np.float32),
            faces.astype(np.int32),
            np.zeros((verts.shape[0], 2), np.float32),
        )
    chart = grow_charts(verts, faces)
    n_charts = chart.max() + 1

    new_verts, new_uvs = [], []
    new_faces = np.zeros_like(faces)
    chart_uvs, chart_areas, chart_slices, chart_face_idx = [], [], [], []
    offset = 0
    for c in range(n_charts):
        fsel = np.nonzero(chart == c)[0]
        if fsel.size == 0:
            continue
        cf = faces[fsel]
        vids, local = np.unique(cf.ravel(), return_inverse=True)
        local_faces = local.reshape(-1, 3).astype(np.int32)
        cv = verts[vids]
        uv = lscm(cv.astype(np.float64), local_faces)
        # world area of the chart
        e1 = cv[local_faces[:, 1]] - cv[local_faces[:, 0]]
        e2 = cv[local_faces[:, 2]] - cv[local_faces[:, 0]]
        area = float(0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1).sum())
        chart_uvs.append(uv)
        chart_areas.append(area)
        new_verts.append(cv)
        chart_slices.append((offset, local_faces))
        chart_face_idx.append(fsel)
        offset += cv.shape[0]

    packed = pack_charts(chart_uvs, chart_areas)
    for (off, local_faces), fsel, uv in zip(chart_slices, chart_face_idx, packed):
        new_faces[fsel] = local_faces + off
        new_uvs.append(uv)

    return (
        np.concatenate(new_verts).astype(np.float32),
        new_faces.astype(np.int32),
        np.clip(np.concatenate(new_uvs), 0.0, 1.0).astype(np.float32),
    )
