"""Table-gradient scatter-add: out[rows[m], :] += upd[m, :].

Counterpart of volsurfs_tpu/ops/pallas/scatter_add.py (the JAX package's
one Pallas kernel, ``scatter_add_levels``). On a CUDA tensor the wrappers
launch kernel K1 (``csrc/scatter_add.cu``: the output zeroed on the
stream, then one float2 atomicAdd per update for F=2, one f32 atomicAdd per
value otherwise); on a CPU tensor they run the plain version. Sums are taken in another order than the plain version's, and
with atomics in an order that changes from run to run, so the two agree to
f32 rounding, not bit for bit.
"""

from __future__ import annotations

import torch

from volsurfs_tpu_torch import _build

# launch counts: the CUDA kernel's and the plain version's
launches = {"scatter_add": 0, "scatter_add_reference": 0}


def scatter_add_rows_reference(rows, upd, total_rows: int):
    """Plain version: rows [M] int, upd [M, F] -> [total_rows, F]."""
    launches["scatter_add_reference"] += 1
    out = torch.zeros(total_rows, upd.shape[1], dtype=upd.dtype, device=upd.device)
    return out.scatter_add_(0, rows.long()[:, None].expand(-1, upd.shape[1]), upd)


def scatter_add_rows(rows, upd, total_rows: int):
    """out [total_rows, F] with out[rows[m], :] += upd[m, :].

    rows [M] int32 absolute rows in [0, total_rows) (rows outside are
    dropped by the kernel); upd [M, F] float32.
    """
    if not upd.is_cuda:
        return scatter_add_rows_reference(rows, upd, total_rows)
    if rows.device != upd.device or rows.dtype != torch.int32 or not rows.is_contiguous():
        raise ValueError(
            f"scatter_add_rows: rows must be contiguous int32 on {upd.device}, "
            f"got {rows.dtype} on {rows.device}"
        )
    if upd.dtype != torch.float32 or not upd.is_contiguous() or upd.ndim != 2:
        raise ValueError(
            f"scatter_add_rows: upd must be a contiguous [M, F] float32 tensor, "
            f"got {upd.dtype} {tuple(upd.shape)}"
        )
    if rows.ndim != 1 or rows.shape[0] != upd.shape[0]:
        raise ValueError(f"scatter_add_rows: rows {tuple(rows.shape)} vs upd {tuple(upd.shape)}")
    out = torch.empty(total_rows, upd.shape[1], dtype=torch.float32, device=upd.device)
    status = _build.kernels().vs_scatter_add_rows(
        rows.data_ptr(), upd.data_ptr(), out.data_ptr(), upd.shape[0],
        upd.shape[1], total_rows, torch.cuda.current_stream(upd.device).cuda_stream,
    )
    _build.check(status, "scatter_add_rows")
    launches["scatter_add"] += 1
    return out


def _level_rows(idx, nr_rows: int):
    L = idx.shape[0]
    offsets = torch.arange(L, dtype=torch.int32, device=idx.device)[:, None] * nr_rows
    return (idx.to(torch.int32) + offsets).reshape(-1)


def scatter_add_levels(idx, upd, nr_rows: int):
    """Per-level scatter-add: out[l, idx[l, m], :] += upd[l, m, :].

    idx [L, M] int in [0, nr_rows); upd [L, M, F] float32.
    Returns [L, nr_rows, F] float32.
    """
    L, M = idx.shape
    F = upd.shape[-1]
    out = scatter_add_rows(
        _level_rows(idx, nr_rows), upd.reshape(L * M, F).contiguous(), L * nr_rows
    )
    return out.reshape(L, nr_rows, F)
