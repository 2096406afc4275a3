"""Parity of the torch port's table-gradient scatter-add (the plain version
of kernel K1) with the JAX package's Pallas kernel and with numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volsurfs_tpu.ops.pallas.scatter_add import scatter_add_levels as jax_scatter_add_levels
from volsurfs_tpu_torch.ops import scatter_add as S

torch.set_num_threads(2)


def test_scatter_add_levels_matches_jax_pallas():
    """At the shape of tests/test_pallas_kernels.py, JAX in interpret mode."""
    rng = np.random.default_rng(3)
    L, M, T, F = 3, 1500, 512, 2
    idx = rng.integers(0, T, (L, M)).astype(np.int32)
    upd = rng.standard_normal((L, M, F)).astype(np.float32)
    ref = np.asarray(jax_scatter_add_levels(jnp.asarray(idx), jnp.asarray(upd), T))
    out = S.scatter_add_levels(torch.from_numpy(idx), torch.from_numpy(upd), T)
    assert out.shape == (L, T, F)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_scatter_add_rows_uneven_levels_matches_numpy():
    """The rows form with levels of different sizes (absolute rows through
    per-level offsets), as the hash-grid backward calls it."""
    rng = np.random.default_rng(4)
    sizes = [324, 676, 1444, 4096, 4096]
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    M, F = 4000, 2
    rows = np.concatenate(
        [rng.integers(0, s, M) + o for s, o in zip(sizes, offsets)]
    ).astype(np.int32)
    upd = rng.standard_normal((rows.shape[0], F)).astype(np.float32)
    ref = np.zeros((sum(sizes), F), np.float64)
    np.add.at(ref, rows, upd.astype(np.float64))
    out = S.scatter_add_rows(torch.from_numpy(rows), torch.from_numpy(upd), sum(sizes))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_scatter_add_collision_heavy_matches_numpy():
    """Every update into 8 rows: thousands of additions per row."""
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 8, 20000).astype(np.int32)
    upd = rng.standard_normal((20000, 2)).astype(np.float32)
    ref = np.zeros((128, 2), np.float64)
    np.add.at(ref, rows, upd.astype(np.float64))
    out = S.scatter_add_rows(torch.from_numpy(rows), torch.from_numpy(upd), 128)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-4)
    assert np.all(out.numpy()[8:] == 0.0)


@pytest.mark.parametrize("nr_feat", [1, 2, 3])
def test_scatter_add_rows_reference_matches_numpy(nr_feat):
    """The plain version for every width the kernel takes: F=2 has the
    kernel's float2 path, other widths its one-value-a-thread path."""
    rng = np.random.default_rng(6 + nr_feat)
    nr_rows, M = 300, 5000
    rows = rng.integers(0, nr_rows, M).astype(np.int32)
    upd = rng.standard_normal((M, nr_feat)).astype(np.float32)
    ref = np.zeros((nr_rows, nr_feat), np.float64)
    np.add.at(ref, rows, upd.astype(np.float64))
    out = S.scatter_add_rows_reference(torch.from_numpy(rows), torch.from_numpy(upd), nr_rows)
    assert out.shape == (nr_rows, nr_feat) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_scatter_add_rows_drops_rows_out_of_range():
    """Rows [0, 5, -1, 9] into 8 rows: -1 and 9 are dropped, as kernel K1
    drops them (exact: one addition per row)."""
    rows = torch.tensor([0, 5, -1, 9], dtype=torch.int32)
    upd = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0], [7.0, 8.0]])
    out = S.scatter_add_rows(rows, upd, 8)
    ref = np.zeros((8, 2), np.float32)
    ref[0] = [1.0, 2.0]
    ref[5] = [3.0, 4.0]
    np.testing.assert_array_equal(out.numpy(), ref)


def test_scatter_add_levels_drops_indices_out_of_range():
    """A level-0 index equal to nr_rows (and one below 0) is dropped and no
    longer lands in level 1's rows (exact: one addition per row)."""
    nr_rows = 8
    idx = torch.tensor([[nr_rows, 2, -1], [1, 3, 3]], dtype=torch.int32)
    upd = torch.arange(12, dtype=torch.float32).reshape(2, 3, 2) + 1.0
    out = S.scatter_add_levels(idx, upd, nr_rows).numpy()
    ref = np.zeros((2, nr_rows, 2), np.float32)
    ref[0, 2] = [3.0, 4.0]
    ref[1, 1] = [7.0, 8.0]
    ref[1, 3] = [9.0 + 11.0, 10.0 + 12.0]
    np.testing.assert_array_equal(out, ref)
