"""Texture coordinates that probe the band-texture fetch of the baked
renderer, shared by the CPU parity tests and the tests on the card (numpy
only, so that a test file without JAX can import it)."""

import numpy as np


def edge_uvs(res, n_random, seed):
    """u, v [n] float32: 0, 1, outside [0, 1], exact texel centres of each
    band resolution in res, points just beside them, and random points in
    [-0.25, 1.25]."""
    special = [0.0, 1.0, -0.3, 1.3, 0.5, 1e-7, 1.0 - 1e-7, -1e-7, 1.0 + 1e-7]
    for r in res:
        special += [0.5 / r, (r - 0.5) / r, 3.5 / r, 3.5 / r + 1e-6, 3.5 / r - 1e-6]
    special = np.asarray(special, np.float32)
    grid_u, grid_v = np.meshgrid(special, special, indexing="ij")
    rng = np.random.default_rng(seed)
    u = np.concatenate([grid_u.reshape(-1), rng.uniform(-0.25, 1.25, n_random)])
    v = np.concatenate([grid_v.reshape(-1), rng.uniform(-0.25, 1.25, n_random)])
    return u.astype(np.float32), v.astype(np.float32)
