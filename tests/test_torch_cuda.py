"""The port's CUDA kernels against their plain versions, on the card.

Imports no JAX, so it runs on a machine without it:
``python -m pytest --noconftest -q tests/test_torch_cuda.py``. Without a
CUDA device every test skips."""

import os

import numpy as np
import pytest
import torch

from volsurfs_tpu_torch.baking.mesh_io import load_obj
from volsurfs_tpu_torch.ops import bvh as TB
from volsurfs_tpu_torch.ops import scatter_add as S

torch.set_num_threads(2)

MESH_DIR = os.path.join(
    os.path.dirname(__file__), "..", "runs", "pipeline_tpu_256", "volsurfs", "meshes"
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("nr_rows", [8, 355278])
def test_scatter_add_kernel_matches_plain(cuda, nr_rows):
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.integers(0, nr_rows, 100000).astype(np.int32)).to(cuda)
    upd = torch.from_numpy(rng.standard_normal((100000, 2)).astype(np.float32)).to(cuda)
    out = S.scatter_add_rows(rows, upd, nr_rows)
    ref = S.scatter_add_rows_reference(rows, upd, nr_rows)
    torch.cuda.synchronize()
    # atomics sum in another order than the plain version
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6 * (100000 / nr_rows + 1))


@pytest.mark.parametrize("nr_feat", [1, 2, 3])
def test_scatter_add_kernel_widths_drop_rows_out_of_range(cuda, nr_feat):
    """Each width (F=2 takes the float2 path, others one value a thread),
    with rows below 0 and at or past the table's end, which the kernel
    drops: it equals the plain version of the rows in range. The output
    comes from torch.empty, so the kernel must zero it."""
    rng = np.random.default_rng(nr_feat)
    nr_rows, M = 4096, 100000
    rows_np = rng.integers(-50, nr_rows + 50, M).astype(np.int32)
    rows = torch.from_numpy(rows_np).to(cuda)
    upd = torch.from_numpy(rng.standard_normal((M, nr_feat)).astype(np.float32)).to(cuda)
    # NaNs in the block that the caching allocator hands to the output next
    torch.full((nr_rows * nr_feat,), float("nan"), device=cuda)
    out = S.scatter_add_rows(rows, upd, nr_rows)
    keep = torch.from_numpy((rows_np >= 0) & (rows_np < nr_rows)).to(cuda)
    ref = S.scatter_add_rows_reference(rows[keep], upd[keep], nr_rows)
    torch.cuda.synchronize()
    assert out.shape == (nr_rows, nr_feat)
    # atomics sum in another order than the plain version
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6 * (M / nr_rows + 1))


def test_scatter_add_rejects_wrong_dtype(cuda):
    with pytest.raises(ValueError):
        S.scatter_add_rows(torch.zeros(4, dtype=torch.int64, device=cuda),
                           torch.zeros(4, 2, device=cuda), 8)


@pytest.mark.parametrize("nr_rays", [512, 16384])
def test_bvh_trace_kernel_matches_plain(cuda, nr_rays):
    """K2 equals its plain version bit for bit, at the train step's ray
    count and at one render chunk's."""
    meshes = [load_obj(os.path.join(MESH_DIR, f"{i}.obj")) for i in range(5)]
    stacked = TB.stack_bvhs([TB.build_bvh(v, f) for v, f, _ in meshes], cuda)
    rng = np.random.default_rng(1)
    o = rng.standard_normal((nr_rays, 3))
    o = 2.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-0.6, 0.6, (nr_rays, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays_o = torch.from_numpy(o.astype(np.float32)).to(cuda)
    rays_d = torch.from_numpy(d.astype(np.float32)).to(cuda)
    out = TB.trace_all(stacked, rays_o, rays_d)
    ref = TB.trace_all_reference(stacked, rays_o, rays_d)
    stacked.check_step_cap()
    assert int(stacked.step_cap.count.item()) == 0
    for key in ("is_hit", "depth", "positions", "barycentric", "triangles_id"):
        assert torch.equal(out[key], ref[key]), key
    assert 0.2 < float(out["is_hit"].float().mean()) < 0.95
