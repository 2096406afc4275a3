"""Input encodings (counterpart of volsurfs_tpu/models/encodings.py): the
hash-grid lookup of the neural textures (``_level_layout``,
``_hash_lookup``), the coarse-to-fine window and the permutohedral encoder
``PermutoEncoder`` of the SDF and colour fields.

The hash-grid forward is a torch gather plus a weighted sum over the
corners. Both backward passes accumulate the table gradient through
``ops.scatter_add`` (kernel K1 on the card) in one call over every (point,
level, corner) update, as the JAX ``_table_grad_accumulate`` does in its
exact ``flat`` mode. The permutohedral lookup is kernel K6
(``ops/permuto.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from volsurfs_tpu_torch.ops import permuto as P
from volsurfs_tpu_torch.ops.scatter_add import scatter_add_rows
from volsurfs_tpu_torch.utils.schedules import map_range_val

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


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1)).bit_length()


def c2f_window(t, nr_levels: int, device=None):
    """Coarse-to-fine window [L]: level l opens as t * L passes l, with a
    cosine ease (t a float32 scalar in [0, 1])."""
    # t L rounded to float32 on the host: a host tensor copied to the device
    # would wait for the device's queue to drain at every lookup
    alpha = float(np.float32(t) * np.float32(nr_levels))
    idx = torch.arange(nr_levels, dtype=torch.float32, device=device)
    w = torch.clamp(alpha - idx, 0.0, 1.0)
    return 0.5 * (1.0 - torch.cos(math.pi * w))


def _rescale_to_unit(points, half):
    """Points in the box of half-sides half [3] -> ([..., 3] in [0, 1]^3,
    [...] out of bounds); without a box (half None) the points as they
    are and no mask."""
    if half is None:
        return points, None
    out_of_bounds = torch.any((points <= -half) | (points >= half), dim=-1)
    return (points / half + 1.0) / 2.0, out_of_bounds


class PermutoEncoder(nn.Module):
    """Permutohedral-lattice hash encoding: 4 simplex corners a level, F = 2
    features a row, levels at scales geomspace(coarsest, finest); each
    level's rows are min(2^log2_hashmap_size, next_pow2(2 (ceil(1/s) + 3)^3))
    (at least 64). ``table`` [total_rows, 2] holds every level's rows, coarse
    to fine. Returns ``(feats, out_of_bounds)``, or with ``with_grads``
    ``(feats, dfeats [3, ..., D], out_of_bounds)``; feats are the windowed
    level features, then the unit-cube point without its last element.
    ``bb_sides=None`` takes the points as they are (the background's,
    contracted into the unit ball), with no out-of-bounds mask (None)."""

    def __init__(self, input_dim: int = 3, nr_levels: int = 24, log2_hashmap_size: int = 18,
                 nr_feat_per_level: int = 2, coarsest_scale: float = 1.0,
                 finest_scale: float = 0.0001, nr_iters_for_c2f: int = 0,
                 concat_points: bool = True, remove_last_element: bool = True,
                 bb_sides=2.0, generator: torch.Generator | None = None):
        super().__init__()
        if input_dim != 3 or nr_feat_per_level != 2:
            raise NotImplementedError("PermutoEncoder: 3-D points and 2 features a level only")
        self.nr_levels = L = nr_levels
        self.nr_iters_for_c2f = nr_iters_for_c2f
        self.concat_points = concat_points
        self.remove_last_element = remove_last_element
        scales = np.geomspace(coarsest_scale, finest_scale, L)
        T = 2 ** log2_hashmap_size
        self.sizes = [min(T, max(64, _next_pow2(2 * (int(np.ceil(1.0 / s) + 3) ** 3))))
                      for s in scales]
        offsets, self.total_rows = _level_layout(self.sizes)
        table = torch.empty(self.total_rows, 2)
        with torch.no_grad():
            table.uniform_(-1e-4, 1e-4, generator=generator)
        self.table = nn.Parameter(table)

        # the elevation E [4, 3] (lattice units) in float64, as numpy 2
        # promotes JAX's float32 E times np.sqrt; W and ddiff are rounded to
        # float32 from float64 once, as JAX stores them
        d = 3
        E = np.zeros((d + 1, d), np.float32)
        for i in range(d):
            E[: i + 1, i] = 1.0 / np.sqrt((i + 1) * (i + 2))
            E[i + 1, i] = -(i + 1) / np.sqrt((i + 1) * (i + 2))
        E = E.astype(np.float64) * np.sqrt(2.0 / 3.0) * (d + 1)
        scales32 = scales.astype(np.float32).astype(np.float64)
        W = np.zeros((3, (d + 1) * L), np.float32)
        for j in range(d + 1):
            W[:, j * L:(j + 1) * L] = E[j, :, None] / scales32[None, :]
        if bb_sides is None:
            half, dunit_dp = None, np.ones(3, np.float32)
        else:
            half = np.broadcast_to(np.asarray(bb_sides, np.float32) / np.float32(2.0), (3,))
            dunit_dp = np.float32(1.0) / (np.float32(2.0) * half)
        ddiff = np.stack([np.stack([(E[j, k] / (d + 1) / scales32).astype(np.float32)
                                    * dunit_dp[k] for k in range(3)]) for j in range(d + 1)])
        self.register_buffer("W", torch.from_numpy(W), persistent=False)
        self.register_buffer("ddiff", torch.from_numpy(ddiff.astype(np.float32)),
                             persistent=False)
        self.register_buffer("half_sides", None if half is None else torch.from_numpy(half.copy()),
                             persistent=False)
        self.register_buffer("dunit_dp", torch.from_numpy(dunit_dp.astype(np.float32)),
                             persistent=False)
        self.register_buffer("level_sizes", torch.tensor(self.sizes, dtype=torch.int32),
                             persistent=False)
        self.register_buffer("level_offsets", torch.from_numpy(offsets), persistent=False)

    @property
    def output_dim(self) -> int:
        return self.nr_levels * 2 + (3 if self.concat_points else 0) \
            - (1 if self.remove_last_element else 0)

    def window(self, iter_nr=None):
        """The coarse-to-fine window of iteration iter_nr, repeated for the
        2 features of a level: [2L]. The last one made is kept: a step and
        an occupancy refresh look up at one iteration many times."""
        t = 1.0 if iter_nr is None else map_range_val(
            np.float32(iter_nr), 0.0, float(self.nr_iters_for_c2f), 0.3, 1.0)
        key = (float(t), self.table.device)
        if getattr(self, "_window", (None,))[0] != key:
            self._window = (key, torch.repeat_interleave(
                c2f_window(t, self.nr_levels, self.table.device), 2))
        return self._window[1]

    def forward(self, points, iter_nr=None, with_grads: bool = False):
        batch_shape = points.shape[:-1]
        unit, out_of_bounds = _rescale_to_unit(points, self.half_sides)
        p = unit.reshape(-1, 3).contiguous()
        window = self.window(iter_nr)
        if not with_grads:
            feats = P.permuto_lookup(self.table, p, self.W, self.level_sizes,
                                     self.level_offsets)
            feats = (feats * window).reshape(*batch_shape, -1)
            if self.concat_points:
                feats = torch.cat([feats, unit], dim=-1)
            if self.remove_last_element:
                feats = feats[..., :-1]
            return feats, out_of_bounds
        feats, dfeats = P.permuto_lookup(
            self.table, p, self.W, self.level_sizes, self.level_offsets, self.ddiff)
        feats = (feats * window).reshape(*batch_shape, -1)
        dfeats = (dfeats * window).reshape(3, *batch_shape, -1)
        if self.concat_points:
            feats = torch.cat([feats, unit], dim=-1)
            dunit = torch.diag(self.dunit_dp).reshape((3,) + (1,) * len(batch_shape) + (3,))
            dfeats = torch.cat([dfeats, dunit.expand(3, *batch_shape, 3)], dim=-1)
        if self.remove_last_element:
            feats = feats[..., :-1]
            dfeats = dfeats[..., :-1]
        return feats, dfeats, out_of_bounds


# encoders of the JAX package that the port does not have yet
_NOT_PORTED_ENCODERS = ("none", "frequency", "spherical_harmonics", "spherical_gaussians",
                        "gridhash")
NOT_PORTED_ITEM = "ROADMAP.md Queue 1 item 5, part 2"


def get_encoder(encoding: str, generator: torch.Generator | None = None, **kwargs):
    """Encoder factory; only ``permutohash`` is ported (the others raise,
    naming ROADMAP.md Queue 1 item 5, part 2)."""
    if encoding == "permutohash":
        return PermutoEncoder(
            input_dim=kwargs.get("input_dim", 3),
            nr_levels=kwargs.get("nr_levels", 24),
            nr_iters_for_c2f=kwargs.get("nr_iters_for_c2f", 0),
            bb_sides=kwargs.get("bb_sides", 2.0),
            generator=generator,
        )
    if encoding in _NOT_PORTED_ENCODERS:
        raise NotImplementedError(
            f"encoding {encoding!r} is not ported to torch yet ({NOT_PORTED_ITEM})")
    raise NotImplementedError(f"unknown encoding {encoding}")
