"""Wavefront OBJ save/load with per-vertex UVs (a copy of
volsurfs_tpu/baking/mesh_io.py, which cannot be imported without JAX)."""

from __future__ import annotations

import numpy as np


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray, uvs: np.ndarray | None = None):
    with open(path, "w") as f:
        f.write("# volsurfs_tpu mesh\n")
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if uvs is not None:
            for uv in uvs:
                f.write(f"vt {uv[0]:.6f} {uv[1]:.6f}\n")
            for tri in faces:
                a, b, c = tri + 1
                f.write(f"f {a}/{a} {b}/{b} {c}/{c}\n")
        else:
            for tri in faces:
                a, b, c = tri + 1
                f.write(f"f {a} {b} {c}\n")


def load_obj(path: str):
    """Returns (verts [V,3], faces [F,3], uvs [V,2] or None).

    Assumes per-vertex UVs (v/vt indices aligned), which is what save_obj and
    the atlas produce.
    """
    verts, uvs, faces = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:4]]
                faces.append(idx)
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    uvs_np = np.asarray(uvs, np.float32) if uvs else None
    return verts, faces, uvs_np
