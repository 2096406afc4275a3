"""Hash-grid lookup with its table gradient (counterpart of the parts of
volsurfs_tpu/models/encodings.py that the neural textures use:
``_level_layout`` and ``_hash_lookup``).

The forward is a torch gather plus a weighted sum over the corners. The
backward accumulates the table gradient through ``ops.scatter_add`` (kernel
K1 on the card) in one call over every (point, level, corner) update, as
the JAX ``_table_grad_accumulate`` does in its exact ``flat`` mode.
"""

from __future__ import annotations

import numpy as np
import torch

from volsurfs_tpu_torch.ops.scatter_add import scatter_add_rows

def _level_layout(sizes):
    """sizes: per-level row counts. Returns (offsets [L] np.int32,
    total_rows): where each level's rows start in the concatenated table."""
    sizes = [int(s) for s in sizes]
    offsets = np.concatenate([[0], np.cumsum(sizes)])[:-1].astype(np.int32)
    return offsets, int(np.sum(sizes))


class HashLookup(torch.autograd.Function):
    """feats [N, L, F] = sum_c bary[n, l, c] * table[flat_idx[n, l, c]].

    table [R, F] float32 (the per-level tables concatenated); flat_idx
    [N, L, C] int64 absolute rows; bary [N, L, C] weights."""

    @staticmethod
    def forward(ctx, table, flat_idx, bary):
        g = table[flat_idx]  # [N, L, C, F]
        feats = torch.sum(bary[..., None] * g, dim=2)
        ctx.save_for_backward(g, flat_idx, bary)
        ctx.total_rows = table.shape[0]
        return feats

    @staticmethod
    def backward(ctx, dout):
        g, flat_idx, bary = ctx.saved_tensors
        d_table = d_bary = None
        if ctx.needs_input_grad[0]:
            upd = bary[..., None] * dout[:, :, None, :]  # [N, L, C, F]
            d_table = scatter_add_rows(
                flat_idx.reshape(-1).to(torch.int32),
                upd.reshape(-1, upd.shape[-1]).contiguous(),
                ctx.total_rows,
            )
        if ctx.needs_input_grad[2]:
            d_bary = torch.sum(g * dout[:, :, None, :], dim=-1)  # [N, L, C]
        return d_table, None, d_bary


def hash_lookup(table, flat_idx, bary):
    return HashLookup.apply(table, flat_idx, bary)
