"""BVH construction (host) and closest-hit tracing of k stacked shells.

Counterpart of volsurfs_tpu/ops/bvh.py. The host half builds each mesh's
BVH with the native binned-SAH builder (``native/bvh_build.cpp``, compiled
by ``_build.bvh_builder``) and flattens it depth-first with miss (skip)
pointers, so traversal is stackless. ``stack_bvhs`` concatenates k such
BVHs (``_stacked_arrays``) into the device layout that kernel K2 reads
(``_compact_layout``: 32 B a node, 48 B a real triangle). ``_pack_nodes``
makes the JAX package's row table of the same arrays, which the parity
tests hold against JAX's.

``trace_all`` traces every ray against every shell. On a CUDA tensor it
launches kernel K2 (``csrc/bvh_trace.cu``); on a CPU tensor it runs the
plain version ``trace_all_reference``, a lockstep loop of the same steps
over the same layout. ``trace_all_buffers`` returns what K2 writes, [k*R]
buffers that the shading kernel K4 reads as they are; ``trace_all`` builds
the dict of [k, R, ...] hits from them.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from volsurfs_tpu_torch import _build
from volsurfs_tpu_torch.utils.math import fma32

LEAF_TRIS = 4  # triangles per leaf (padded); K2 tests at most this many

# launch counts: the CUDA kernel's and the plain version's
launches = {"bvh_trace": 0, "bvh_trace_reference": 0}


@dataclasses.dataclass
class BVH:
    """Flattened BVH of one mesh (host arrays).

    node_lo/node_hi [N, 3] boxes; node_skip [N] miss pointer; node_first [N]
    first leaf slot or -1 for inner nodes; tri_v0/e1/e2 [S, 3] padded leaf
    triangles; tri_id [S] face index (-1 pad).
    """

    node_lo: np.ndarray
    node_hi: np.ndarray
    node_skip: np.ndarray
    node_first: np.ndarray
    tri_v0: np.ndarray
    tri_e1: np.ndarray
    tri_e2: np.ndarray
    tri_id: np.ndarray


def _pack_nodes(node_lo, node_hi, node_skip, node_first,
                tri_v0, tri_e1, tri_e2, tri_id, leaf_size=LEAF_TRIS):
    """Pack each node's traversal working set into ONE float32 row.

    Row layout (width 8 + 10*leaf_size, padded to a multiple of 8):
      [0]        tag: 1.0 leaf / 0.0 inner
      [1]        skip pointer (int32 bits)
      [2:5, 5:8] box lo / hi
      [8 : 8+9L] leaf triangles, L x (v0, e1, e2) row-major
      [8+9L : 8+10L] leaf face ids (int32 bits; -1 pad)
    Inner nodes leave the triangle region zeroed.
    """
    node_first = np.asarray(node_first, np.int32)
    n = node_first.shape[0]
    width = ((8 + 10 * leaf_size + 7) // 8) * 8
    out = np.zeros((n, width), np.float32)
    is_leaf = node_first >= 0
    out[:, 0] = is_leaf.astype(np.float32)
    out[:, 1] = np.asarray(node_skip, np.int32).view(np.float32)
    out[:, 2:5] = np.asarray(node_lo, np.float32)
    out[:, 5:8] = np.asarray(node_hi, np.float32)
    leaf_ids = np.nonzero(is_leaf)[0]
    if leaf_ids.size:
        slots = node_first[leaf_ids][:, None] + np.arange(leaf_size)[None, :]
        tris = np.concatenate(
            [
                np.asarray(tri_v0, np.float32)[slots],
                np.asarray(tri_e1, np.float32)[slots],
                np.asarray(tri_e2, np.float32)[slots],
            ],
            axis=-1,
        )  # [leaves, leaf_size, 9] as (v0, e1, e2)
        out[leaf_ids, 8 : 8 + 9 * leaf_size] = tris.reshape(len(leaf_ids), -1)
        out[leaf_ids, 8 + 9 * leaf_size : 8 + 10 * leaf_size] = (
            np.asarray(tri_id, np.int32)[slots].view(np.float32)
        )
    return out


def _compact_layout(node_lo, node_hi, node_skip, node_first,
                    tri_v0, tri_e1, tri_e2, tri_id, leaf_size=LEAF_TRIS):
    """K2's device layout of a flattened BVH: (nodes [N, 8], tris [T, 12]).

    A node row is two 16-byte halves (skip, first and count as int32 bits):
      inner: [lo.x, lo.y, lo.z, skip | hi.x, hi.y, hi.z, 0.0]
      leaf:  [first, count, 0, skip  | 0, 0, 0, 1.0]
    A leaf's box is never tested, as in JAX, so it holds its triangles'
    first row and count instead. A triangle row is three 16-byte thirds,
    [v0.xyz, id | e1.xyz, 0 | e2.xyz, 0]; ``tris`` holds only the real
    (id >= 0) leaf slots, in slot order, so a leaf's triangles are rows
    first .. first+count-1. A -1 pad never hits, so dropping the pads
    changes no first minimum.
    """
    node_first = np.asarray(node_first, np.int32)
    tri_id = np.asarray(tri_id, np.int32)
    is_leaf = node_first >= 0
    real = tri_id >= 0
    row_of_slot = (np.cumsum(real) - real).astype(np.int32)  # rows before each slot
    nodes = np.zeros((node_first.shape[0], 8), np.float32)
    nodes[:, 0:3] = node_lo
    nodes[:, 3] = np.asarray(node_skip, np.int32).view(np.float32)
    nodes[:, 4:7] = node_hi
    nodes[:, 7] = is_leaf
    leaf_ids = np.nonzero(is_leaf)[0]
    if leaf_ids.size:
        slots = node_first[leaf_ids][:, None] + np.arange(leaf_size)[None, :]
        nodes[leaf_ids, 0:3] = 0.0
        nodes[leaf_ids, 4:7] = 0.0
        nodes[leaf_ids, 0] = row_of_slot[slots[:, 0]].view(np.float32)
        nodes[leaf_ids, 1] = real[slots].sum(axis=1).astype(np.int32).view(np.float32)
    tris = np.zeros((int(real.sum()), 12), np.float32)
    tris[:, 0:3] = np.asarray(tri_v0, np.float32)[real]
    tris[:, 3] = tri_id[real].view(np.float32)
    tris[:, 4:7] = np.asarray(tri_e1, np.float32)[real]
    tris[:, 8:11] = np.asarray(tri_e2, np.float32)[real]
    return nodes, tris


def build_bvh(verts: np.ndarray, faces: np.ndarray, leaf_size: int = LEAF_TRIS) -> BVH:
    """Binned-SAH BVH through the native builder; raises if it fails."""
    lib = _build.bvh_builder()
    v32 = np.ascontiguousarray(verts, np.float32)
    f32 = np.ascontiguousarray(faces, np.int32)
    nf = f32.shape[0]
    if v32.ndim != 2 or v32.shape[1] != 3 or f32.ndim != 2 or f32.shape[1] != 3:
        raise ValueError(f"bad mesh shapes {v32.shape}, {f32.shape}")
    if nf == 0 or f32.min() < 0 or f32.max() >= v32.shape[0]:
        raise ValueError("faces must be non-empty and index the vertices")
    cap = 2 * nf
    node_lo = np.empty((cap, 3), np.float32)
    node_hi = np.empty((cap, 3), np.float32)
    node_skip = np.empty(cap, np.int32)
    node_first = np.empty(cap, np.int32)
    leaf_tri = np.empty(cap * leaf_size, np.int32)
    n_slots = ctypes.c_int(0)
    n = lib.bvh_build_sah(
        v32.ctypes.data, v32.shape[0], f32.ctypes.data, nf, leaf_size,
        node_lo.ctypes.data, node_hi.ctypes.data, node_skip.ctypes.data,
        node_first.ctypes.data, leaf_tri.ctypes.data, ctypes.addressof(n_slots),
    )
    if n <= 0:
        raise RuntimeError(f"native BVH build failed (returned {n})")

    v0 = v32[f32[:, 0]]
    e1 = v32[f32[:, 1]] - v0
    e2 = v32[f32[:, 2]] - v0
    tri_idx = leaf_tri[: n_slots.value]
    valid = tri_idx >= 0
    safe = np.where(valid, tri_idx, 0)
    t_v0 = np.where(valid[:, None], v0[safe], 0.0).astype(np.float32)
    t_e1 = np.where(valid[:, None], e1[safe], 0.0).astype(np.float32)
    t_e2 = np.where(valid[:, None], e2[safe], 0.0).astype(np.float32)
    t_id = np.where(valid, tri_idx, -1).astype(np.int32)
    node_lo, node_hi = node_lo[:n], node_hi[:n]
    node_skip, node_first = node_skip[:n], node_first[:n]
    return BVH(
        node_lo=node_lo, node_hi=node_hi, node_skip=node_skip,
        node_first=node_first, tri_v0=t_v0, tri_e1=t_e1, tri_e2=t_e2,
        tri_id=t_id,
    )


class StepCapGuard:
    """K2's count of cursors that hit the step cap, summed on the device over
    every trace of one StackedBVH. After each launch the count is copied to
    pinned host memory without a sync; ``check`` reads that copy once it has
    landed (at the next trace), or waits for it with ``wait=True``, and
    raises if any cursor hit the cap."""

    def __init__(self, device):
        self.count = torch.zeros(1, dtype=torch.int32, device=device)
        self._host = torch.zeros(1, dtype=torch.int32, pin_memory=True)
        self._copied = None

    def launched(self):
        self._host.copy_(self.count, non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record()

    def check(self, wait=False):
        if self._copied is None:
            return
        if wait:
            self._copied.synchronize()
        elif not self._copied.query():
            return
        n_over = int(self._host[0])
        if n_over:
            raise RuntimeError(
                f"bvh_trace: {n_over} cursors hit the step cap (bad skip pointers)"
            )


@dataclasses.dataclass
class StackedBVH:
    """k flattened BVHs concatenated, with node and slot offsets applied.

    nodes [Nt, 8] and tris [T, 12] float32 are K2's device layout
    (``_compact_layout``). node_begin [k] is the root row of mesh m and
    node_end [k] one past its last row. step_cap is K2's overflow guard,
    made at the first trace on a CUDA device."""

    nodes: torch.Tensor
    tris: torch.Tensor
    node_begin: torch.Tensor
    node_end: torch.Tensor
    leaf_size: int = LEAF_TRIS
    step_cap: StepCapGuard | None = dataclasses.field(default=None, repr=False)

    def check_step_cap(self):
        """Raise if a cursor of any earlier K2 trace hit its step cap
        (waits for the last trace's count to reach the host)."""
        if self.step_cap is not None:
            self.step_cap.check(wait=True)


def _stacked_arrays(bvhs):
    """The BVHs' arrays concatenated, skip and first offset to the stacked
    rows: (node_lo, node_hi, node_skip, node_first, tri_v0, tri_e1, tri_e2,
    tri_id), the arguments of ``_compact_layout`` and ``_pack_nodes``."""
    node_offsets = np.cumsum([0] + [int(b.node_first.shape[0]) for b in bvhs])
    slot_offsets = np.cumsum([0] + [int(b.tri_v0.shape[0]) for b in bvhs])
    skips, firsts = [], []
    for m, b in enumerate(bvhs):
        skips.append(b.node_skip + node_offsets[m])
        firsts.append(np.where(b.node_first >= 0, b.node_first + slot_offsets[m], -1))
    return (
        np.concatenate([b.node_lo for b in bvhs]),
        np.concatenate([b.node_hi for b in bvhs]),
        np.concatenate(skips).astype(np.int32),
        np.concatenate(firsts).astype(np.int32),
        np.concatenate([b.tri_v0 for b in bvhs]),
        np.concatenate([b.tri_e1 for b in bvhs]),
        np.concatenate([b.tri_e2 for b in bvhs]),
        np.concatenate([b.tri_id for b in bvhs]),
    )


def stack_bvhs(bvhs, device="cuda") -> StackedBVH:
    """Concatenate flattened BVHs with node/slot offsets applied."""
    node_offsets = np.cumsum([0] + [int(b.node_first.shape[0]) for b in bvhs])
    nodes, tris = _compact_layout(*_stacked_arrays(bvhs))
    return StackedBVH(
        nodes=torch.from_numpy(nodes).to(device),
        tris=torch.from_numpy(tris).to(device),
        node_begin=torch.from_numpy(node_offsets[:-1].astype(np.int32)).to(device),
        node_end=torch.from_numpy(node_offsets[1:].astype(np.int32)).to(device),
    )


def mesh_orientation(verts, faces) -> int:
    """+1 if the mesh is wound with outward normals (positive signed
    volume), -1 if inward, 0 if degenerate (|volume| tiny): the back-face
    cull sign of ``trace_all`` (volsurfs_tpu/renderers/raster.py's
    ``mesh_orientation``)."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    vol = np.sum(np.einsum("ij,ij->i", v0, np.cross(v1, v2))) / 6.0
    scale = np.abs(verts).max() + 1e-12
    if np.abs(vol) < 1e-9 * scale**3:
        return 0
    return 1 if vol > 0 else -1


def _hits_dict(t_best, tri_best, u_best, v_best, rays_o, rays_d, k):
    """Kernel/loop outputs [k*R] -> the trace_all dict of [k, R, ...]."""
    R = rays_o.shape[0]
    is_hit = tri_best >= 0
    depth = torch.where(is_hit, t_best, 0.0).reshape(k, R, 1)
    return {
        "is_hit": is_hit.reshape(k, R),
        "depth": depth,
        "positions": rays_o[None] + depth * rays_d[None],
        "barycentric": torch.stack([u_best, v_best], dim=-1).reshape(k, R, 2),
        "triangles_id": tri_best.reshape(k, R),
    }


def trace_all(stacked: StackedBVH, rays_o, rays_d, cull=None):
    """Closest hit of every ray against every mesh.

    rays_o, rays_d [R, 3] float32. cull: None, or int32 [k] back-face cull
    signs (``mesh_orientation``; 0 keeps every face of that mesh), valid only
    for rays that start outside every closed shell. Returns is_hit [k, R],
    depth [k, R, 1], positions [k, R, 3], barycentric [k, R, 2] (u, v: P =
    (1-u-v) V0 + u V1 + v V2) and triangles_id [k, R] (mesh-local face ids,
    -1 on a miss).
    """
    if not rays_o.is_cuda:
        return trace_all_reference(stacked, rays_o, rays_d, cull)
    t_best, tri_best, u_best, v_best = trace_all_buffers(stacked, rays_o, rays_d, cull)
    return _hits_dict(t_best, tri_best.long(), u_best, v_best, rays_o, rays_d,
                      stacked.node_begin.shape[0])


def trace_all_buffers(stacked: StackedBVH, rays_o, rays_d, cull=None):
    """``trace_all`` as K2 writes it, with nothing built around it: (t
    float32, triangles_id int32, u float32, v float32), each [k*R] with
    mesh m's rays at [m*R, (m+1)*R); a miss has id -1 (its t is inf, its u
    and v 0). Arguments as for ``trace_all``."""
    if not rays_o.is_cuda:
        t_best, tri_best, u_best, v_best = _trace_reference_buffers(
            stacked, rays_o, rays_d, cull, False)[0]
        return t_best, tri_best.int(), u_best, v_best
    nodes, tris = stacked.nodes, stacked.tris
    begin, end = stacked.node_begin, stacked.node_end
    for name, x, dtype in (
        ("nodes", nodes, torch.float32), ("tris", tris, torch.float32),
        ("node_begin", begin, torch.int32), ("node_end", end, torch.int32),
        ("rays_o", rays_o, torch.float32), ("rays_d", rays_d, torch.float32),
        ("cull", begin if cull is None else cull, torch.int32),
    ):
        if x.device != rays_o.device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(
                f"trace_all: {name} must be a contiguous {dtype} tensor on "
                f"{rays_o.device}, got {x.dtype} on {x.device}"
            )
    if (nodes.ndim != 2 or nodes.shape[1] != 8 or tris.ndim != 2 or tris.shape[1] != 12
            or rays_o.ndim != 2 or rays_o.shape[1] != 3 or rays_d.shape != rays_o.shape
            or (cull is not None and cull.shape != begin.shape)):
        raise ValueError(
            f"trace_all: bad shapes {nodes.shape}, {tris.shape}, {rays_o.shape}, {rays_d.shape}"
        )
    if stacked.leaf_size > LEAF_TRIS:  # the kernel holds at most LEAF_TRIS a leaf
        raise ValueError(f"trace_all: leaves of {stacked.leaf_size} > {LEAF_TRIS} triangles")
    k, R = begin.shape[0], rays_o.shape[0]
    dev = rays_o.device
    if stacked.step_cap is None:
        stacked.step_cap = StepCapGuard(dev)
    stacked.step_cap.check()
    t_best = torch.empty(k * R, dtype=torch.float32, device=dev)
    tri_best = torch.empty(k * R, dtype=torch.int32, device=dev)
    u_best = torch.empty(k * R, dtype=torch.float32, device=dev)
    v_best = torch.empty(k * R, dtype=torch.float32, device=dev)
    status = _build.kernels().vs_bvh_trace(
        nodes.data_ptr(), tris.data_ptr(), begin.data_ptr(), end.data_ptr(), k,
        rays_o.data_ptr(), rays_d.data_ptr(), R, t_best.data_ptr(), tri_best.data_ptr(),
        u_best.data_ptr(), v_best.data_ptr(), None if cull is None else cull.data_ptr(),
        stacked.step_cap.count.data_ptr(),
        torch.cuda.get_device_properties(dev).multi_processor_count,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(status, "bvh_trace")
    launches["bvh_trace"] += 1
    stacked.step_cap.launched()
    return t_best, tri_best, u_best, v_best



def _moller_trumbore(tris, rays_o, rays_d, cull_sign=None, eps=1e-9):
    """tris [B, L, 9] as (v0, e1, e2); rays [B, 3]; cull_sign None or [B]
    float (+1 or -1 keeps the faces with cull_sign * det > 0, 0 keeps all)
    -> (t, u, v, hit) [B, L].

    Written out component by component with the fmas of the kernel
    (csrc/bvh_trace.cu), so that both round alike."""
    v0 = [tris[..., a] for a in range(3)]
    e1 = [tris[..., 3 + a] for a in range(3)]
    e2 = [tris[..., 6 + a] for a in range(3)]
    o = [rays_o[:, None, a] for a in range(3)]
    d = [rays_d[:, None, a] for a in range(3)]
    px = fma32(d[1], e2[2], -(d[2] * e2[1]))
    py = fma32(d[2], e2[0], -(d[0] * e2[2]))
    pz = fma32(d[0], e2[1], -(d[1] * e2[0]))
    det = fma32(e1[2], pz, fma32(e1[1], py, e1[0] * px))
    det_ok = torch.abs(det) > eps
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    tx, ty, tz = o[0] - v0[0], o[1] - v0[1], o[2] - v0[2]
    u = fma32(tz, pz, fma32(ty, py, tx * px)) * inv_det
    qx = fma32(ty, e1[2], -(tz * e1[1]))
    qy = fma32(tz, e1[0], -(tx * e1[2]))
    qz = fma32(tx, e1[1], -(ty * e1[0]))
    v = fma32(d[2], qz, fma32(d[1], qy, d[0] * qx)) * inv_det
    t = fma32(e2[2], qz, fma32(e2[1], qy, e2[0] * qx)) * inv_det
    hit = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-6)
    if cull_sign is not None:
        cs = cull_sign[:, None]
        hit = hit & ((cs == 0.0) | (cs * det > 0.0))
    return t, u, v, hit


def trace_all_reference(stacked: StackedBVH, rays_o, rays_d, cull=None, return_work=False):
    """Plain version of ``trace_all``: every (mesh, ray) cursor advances one
    node per iteration, in lockstep, until all have left their mesh's rows.
    It reads K2's layout (``stacked.nodes``, ``stacked.tris``) and makes
    the same tests in the same order as the kernel.

    With return_work, returns (hits, work): work counts the box tests of
    inner nodes and the triangle tests of leaf triangles (the layout holds
    no pads) that the cursors made, the work a trace of these rays needs;
    the distinct nodes and triangles they read (``nodes_read``,
    ``triangles_read``), the table bytes it needs; and the node visits of
    all cursors and of the longest one (the chain of dependent node loads
    that one kernel thread makes)."""
    buffers, work = _trace_reference_buffers(stacked, rays_o, rays_d, cull, return_work)
    hits = _hits_dict(*buffers, rays_o, rays_d, stacked.node_begin.shape[0])
    return (hits, work) if return_work else hits


def _trace_reference_buffers(stacked: StackedBVH, rays_o, rays_d, cull, return_work):
    """The loop of ``trace_all_reference``: ((t, triangles_id int64, u, v)
    [k*R], work or None)."""
    launches["bvh_trace_reference"] += 1
    nodes, tris = stacked.nodes, stacked.tris
    k, R = stacked.node_begin.shape[0], rays_o.shape[0]
    n_nodes, n_tris = nodes.shape[0], tris.shape[0]
    o = rays_o.repeat(k, 1)
    d = rays_d.repeat(k, 1)
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-12, 1e-12, d)
    node = stacked.node_begin.long().repeat_interleave(R)
    end = stacked.node_end.long().repeat_interleave(R)
    cull_sign = None if cull is None else cull.float().repeat_interleave(R)
    t_best = torch.full((k * R,), float("inf"), device=o.device)
    tri_best = torch.full((k * R,), -1, dtype=torch.long, device=o.device)
    u_best = torch.zeros(k * R, device=o.device)
    v_best = torch.zeros(k * R, device=o.device)
    slot = torch.arange(stacked.leaf_size, device=o.device)
    mt_cols = torch.tensor([0, 1, 2, 4, 5, 6, 8, 9, 10], device=o.device)  # v0, e1, e2
    cap = int((stacked.node_end - stacked.node_begin).max()) + 1
    box_tests = torch.zeros((), dtype=torch.long, device=o.device)
    triangle_tests = torch.zeros((), dtype=torch.long, device=o.device)
    visits = torch.zeros(k * R, dtype=torch.long, device=o.device)
    visited = torch.zeros(n_nodes, dtype=torch.bool, device=o.device)
    for _ in range(cap):
        active = node < end
        if not bool(active.any()):
            break
        row = nodes[torch.clamp(node, max=n_nodes - 1)]
        is_leaf = row[:, 7] > 0.5
        bits = row[:, :4].contiguous().view(torch.int32).long()  # first, count, -, skip
        t0 = (row[:, 0:3] - o) * inv_d
        t1 = (row[:, 4:7] - o) * inv_d
        t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
        t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
        box_hit = (t_far >= t_near) & (t_far > 0.0) & (t_near < t_best)

        count = torch.where(is_leaf & active, bits[:, 1], 0)
        real = slot[None, :] < count[:, None]  # [B, L]
        tri = tris[torch.clamp(bits[:, 0:1] + slot[None, :], 0, max(n_tris - 1, 0))]
        tid = tri[..., 3].contiguous().view(torch.int32).long()
        if return_work:
            box_tests += (active & ~is_leaf).sum()
            triangle_tests += count.sum()
            visits += active
            visited[node[active]] = True
        t, u, v, hit = _moller_trumbore(tri[..., mt_cols], o, d, cull_sign)
        hit = hit & real & (t < t_best[:, None])
        t = torch.where(hit, t, float("inf"))
        t_leaf, j = torch.min(t, dim=-1)  # first minimum wins
        better = t_leaf < t_best
        j = j[:, None]
        t_best = torch.where(better, t_leaf, t_best)
        tri_best = torch.where(better, torch.gather(tid, 1, j)[:, 0], tri_best)
        u_best = torch.where(better, torch.gather(u, 1, j)[:, 0], u_best)
        v_best = torch.where(better, torch.gather(v, 1, j)[:, 0], v_best)

        descend = box_hit & ~is_leaf
        node = torch.where(active, torch.where(descend, node + 1, bits[:, 3]), node)
    else:
        if bool((node < end).any()):
            raise RuntimeError("trace_all_reference: cursors hit the step cap")
    buffers = (t_best, tri_best, u_best, v_best)
    if not return_work:
        return buffers, None
    leaves_read = visited & (nodes[:, 7] > 0.5)  # a leaf's triangles are all tested
    leaf_counts = nodes[:, 1].contiguous().view(torch.int32).long()
    return buffers, {"box_tests": int(box_tests), "triangle_tests": int(triangle_tests),
                     "nodes_read": int(visited.sum()),
                     "triangles_read": int(leaf_counts[leaves_read].sum()),
                     "node_visits": int(visits.sum()), "max_node_visits": int(visits.max())}


def face_depth(verts, faces, face_ids, rays_o, rays_d):
    """Depth at which each ray meets one face of a mesh under the hit rule
    of ``trace_all`` (inf where it misses it, or where the id is -1).

    verts [V, 3], faces [F, 3] numpy; face_ids [n] and rays [n, 3] tensors."""
    dev = rays_o.device
    v = torch.from_numpy(np.ascontiguousarray(verts, np.float32)).to(dev)
    f = torch.from_numpy(np.ascontiguousarray(faces, np.int64)).to(dev)
    face = f[torch.clamp(face_ids.long(), min=0)]
    v0 = v[face[:, 0]]
    tris = torch.cat([v0, v[face[:, 1]] - v0, v[face[:, 2]] - v0], dim=-1)[:, None]
    t, _, _, hit = _moller_trumbore(tris, rays_o, rays_d)
    return torch.where(hit[:, 0] & (face_ids >= 0), t[:, 0], float("inf"))


def face_id_mismatches(meshes, out, ref, rays_o, rays_d, tol=1e-6):
    """Count the (mesh, ray) pairs where two traces disagree on the face id
    and the tie rule does not excuse it: a mismatch is excused only where
    ``out``'s face, tested again on its own, meets the ray within tol of
    ``ref``'s depth (two faces tie for the closest hit).

    meshes: k (verts, faces) numpy pairs; out, ref: ``trace_all`` dicts."""
    unexplained = 0
    for m, (verts, faces) in enumerate(meshes):
        r = torch.nonzero(out["triangles_id"][m] != ref["triangles_id"][m])[:, 0]
        if r.numel() == 0:
            continue
        t = face_depth(verts, faces, out["triangles_id"][m, r], rays_o[r], rays_d[r])
        unexplained += int((torch.abs(t - ref["depth"][m, r, 0]) > tol).sum())
    return unexplained


@dataclasses.dataclass
class TensorMesh:
    """Device mesh with per-vertex UVs and normals."""

    verts: torch.Tensor  # [V, 3]
    faces: torch.Tensor  # [F, 3] int64
    uvs: torch.Tensor | None  # [V, 2]
    normals: torch.Tensor  # [V, 3]

    def face_attr(self, attr, face_ids, bary_uv):
        """Interpolate a per-vertex attribute at (face, barycentric) hits:
        (1-u-v) A0 + u A1 + v A2."""
        f = self.faces[torch.clamp(face_ids, min=0)]
        a = attr[f[..., 0]]
        b = attr[f[..., 1]]
        c = attr[f[..., 2]]
        u = bary_uv[..., 0:1]
        v = bary_uv[..., 1:2]
        return (1.0 - u - v) * a + u * b + v * c


def compute_vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    fn = np.cross(
        verts[faces[:, 1]] - verts[faces[:, 0]],
        verts[faces[:, 2]] - verts[faces[:, 0]],
    )
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    return (vn / np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)).astype(
        np.float32
    )


def make_tensor_mesh(verts, faces, uvs=None, device="cuda") -> TensorMesh:
    verts = np.array(verts, np.float32)
    faces = np.array(faces, np.int64)
    return TensorMesh(
        verts=torch.from_numpy(verts).to(device),
        faces=torch.from_numpy(faces).to(device),
        uvs=None if uvs is None else torch.from_numpy(np.array(uvs, np.float32)).to(device),
        normals=torch.from_numpy(compute_vertex_normals(verts, faces)).to(device),
    )
