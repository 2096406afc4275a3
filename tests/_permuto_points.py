"""Points of the surf stage's kinds for the permutohedral lookup's tests
(numpy only, so that the card's tests can take them without JAX)."""

import numpy as np


def kinds_of_points(rng, kind, n=2048):
    """float32 [~n, 3] points of one kind: a data step's or a sphere-init
    step's ("ball": uniform in the bounding ball, 16 at the invalid samples'
    depth 1e10), an occupancy refresh's ("refresh": voxel centres of the
    box, the nearest cube of n), or outside the box ("outside")."""
    if kind == "refresh":
        side = int(round(n ** (1 / 3)))
        c = (np.arange(side, dtype=np.float32) + 0.5) / side * 2.0 - 1.0
        return np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)
    pts = rng.standard_normal((n, 3))
    pts *= rng.uniform(0, 1, (n, 1)) ** (1 / 3) / np.linalg.norm(pts, axis=-1, keepdims=True)
    if kind == "outside":
        pts *= 1.6
    else:
        pts[:16] = 1e10
    return pts.astype(np.float32)
