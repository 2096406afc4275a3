"""The scene on which the port's smoke run and kernel timings drive the
volsurfs slice: the five shells committed in
``runs/pipeline_tpu_256/volsurfs/meshes/`` and the procedural sphere scene
of ``synthetic.py`` around them (training split seed 0, test camera seed 1).
"""

from __future__ import annotations

import os

import torch

from volsurfs_tpu_torch.baking.mesh_io import load_obj
from volsurfs_tpu_torch.datasets.cameras import get_camera_rays
from volsurfs_tpu_torch.datasets.synthetic import make_synthetic_split

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MESH_DIR = os.path.join(REPO, "runs", "pipeline_tpu_256", "volsurfs", "meshes")

FRAME = 256  # the cameras' width and height


def load_shells():
    """The committed shells, as load_obj's (verts, faces, uvs), in file order."""
    files = sorted(f for f in os.listdir(MESH_DIR) if f.endswith(".obj"))
    return [load_obj(os.path.join(MESH_DIR, f)) for f in files]


def train_split(nr_cameras=24, size=FRAME):
    """The sphere scene's training split (seed 0): (cameras, rgbs, masks)."""
    return make_synthetic_split(nr_cameras, size, size, cam_radius=2.0, sphere_radius=0.5, seed=0)


def test_camera(device, size=FRAME):
    """Rays [size*size, 3] of the sphere scene's first test camera (seed 1)
    on device, and its ground-truth image [size, size, 3] (numpy)."""
    cams, rgbs, _ = make_synthetic_split(4, size, size, cam_radius=2.0, sphere_radius=0.5, seed=1)
    rays_o, rays_d = get_camera_rays(cams[0])
    return (torch.from_numpy(rays_o).to(device), torch.from_numpy(rays_d).to(device), rgbs[0])
