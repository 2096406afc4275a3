"""Quadric mesh simplification through the native library (counterpart of
volsurfs_tpu/baking/simplify.py): ``native/mesh_simplify.cpp``, built with
g++ into ``volsurfs_tpu_torch/_build/libmesh_simplify.so`` at first use
(``_build.mesh_simplifier``) and bound with ctypes. It runs on the host.
"""

from __future__ import annotations

import numpy as np

from volsurfs_tpu_torch import _build


def simplify_mesh(verts: np.ndarray, faces: np.ndarray, target_faces_ratio: float = 0.025):
    """Quadric edge-collapse decimation to ``target_faces_ratio`` of the input
    face count (the pipeline simplifies to 2.5%).

    Returns (verts [V', 3] float32, faces [F', 3] int32).
    """
    lib = _build.mesh_simplifier()
    v = np.ascontiguousarray(verts, np.float64)
    f = np.ascontiguousarray(faces, np.int32)
    nv, nf = v.shape[0], f.shape[0]
    target = max(4, int(nf * target_faces_ratio))
    out_v = np.zeros_like(v)
    out_f = np.zeros_like(f)
    out_nv = np.zeros(1, np.int32)
    got_nf = lib.mesh_simplify(v.ctypes.data, nv, f.ctypes.data, nf, target,
                               out_v.ctypes.data, out_f.ctypes.data, out_nv.ctypes.data)
    return out_v[:int(out_nv[0])].astype(np.float32), out_f[:got_nf].copy()
