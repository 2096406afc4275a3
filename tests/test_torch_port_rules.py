"""Rules of the torch port: it imports nothing of JAX or of the JAX package,
it does not fall back to the CPU when CUDA is asked for, and CPU tensors go
to the plain versions of its kernels."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from volsurfs_tpu_torch.methods import volsurfs as TV
from volsurfs_tpu_torch.ops import bvh as TB
from volsurfs_tpu_torch.ops import scatter_add as S
from volsurfs_tpu_torch.params.hyper_params import HyperParamsVolSurfs

torch.set_num_threads(2)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
FORBIDDEN = ("jax", "flax", "optax", "volsurfs_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "volsurfs_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax_or_jax_package():
    files = _port_files()
    assert len(files) > 10
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in FORBIDDEN:  # exact top-level match: volsurfs_tpu_torch passes
                bad.append((os.path.relpath(path, REPO), mod))
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'volsurfs_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import volsurfs_tpu_torch\n"
        "import volsurfs_tpu_torch.methods.volsurfs, volsurfs_tpu_torch.convert\n"
        "import volsurfs_tpu_torch.datasets.synthetic, volsurfs_tpu_torch.datasets.tensor_reel\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _tetra():
    verts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32) - 0.3
    faces = np.asarray([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.int32)
    uvs = verts[:, :2] + 0.5
    return verts, faces, uvs


def test_volsurfs_without_device_needs_cuda(monkeypatch):
    """The default device is CUDA; without it the constructor raises instead
    of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hp = HyperParamsVolSurfs(
        using_neural_textures=True, appearance_predict_sh_coeffs=True,
        rgb_normal_dep=False, transp_normal_dep=False, sh_degree=0,
    )
    with pytest.raises(RuntimeError, match="cuda"):
        TV.VolSurfs(hp, [_tetra()])


def test_cpu_tensors_take_the_plain_versions():
    for counts in (S.launches, TB.launches):
        for key in counts:
            counts[key] = 0
    rows = torch.tensor([0, 3, 3], dtype=torch.int32)
    out = S.scatter_add_rows(rows, torch.ones(3, 2), 4)
    np.testing.assert_array_equal(out.numpy(), [[1, 1], [0, 0], [0, 0], [2, 2]])
    v, f, _ = _tetra()
    stacked = TB.stack_bvhs([TB.build_bvh(v, f)], "cpu")
    hits = TB.trace_all(
        stacked, torch.tensor([[0.0, 0.0, -2.0]]), torch.tensor([[0.0, 0.0, 1.0]])
    )
    assert bool(hits["is_hit"][0, 0])
    assert S.launches == {"scatter_add": 0, "scatter_add_reference": 1}
    assert TB.launches == {"bvh_trace": 0, "bvh_trace_reference": 1}
