"""Neural textures: 2D hash grid + small MLP, SH texture pyramids.

Counterpart of volsurfs_tpu/models/textures.py:

- ``HashGrid2D``: 16-level 2D hash encoding (2 features, 2^15 rows, base
  res 16, growth 1.5), with direct indexing on the coarse levels that fit;
- ``NeuralTexture``: hash grid + 64x64 ReLU MLP with ``bake`` (raw uv),
  ``anchor`` (snap to the texel center) and ``lerp`` (bilinear blend of the
  four texel-center OUTPUTS in float16) sampling, sigmoid squeeze,
  straight-through 0-255 quantisation and expansion to a value range;
- ``SHNeuralTextures``: one texture per SH band, SH evaluation in float16.

The float16 casts sit where the JAX code has them. UV convention: u along
the width, v along the height with v=0 at the texture bottom.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from volsurfs_tpu_torch.models.encodings import _level_layout, hash_lookup
from volsurfs_tpu_torch.models.mlp import MLP
from volsurfs_tpu_torch.ops.sh import sh_eval

_PRIMES_2D = (1, 2654435761)
_MASK32 = 0xFFFFFFFF


def round_ste(x):
    """Round with a straight-through gradient."""
    return x + (torch.round(x) - x).detach()


def _mul_u32(a, prime: int):
    """(a * prime) mod 2^32 for int64 a in [0, 2^32), without int64 overflow."""
    lo, hi = prime & 0xFFFF, prime >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


class HashGrid2D(nn.Module):
    """2D multiresolution hash encoding; ``table`` holds every level's rows
    (coarse to fine) as one [total_rows, F] float32 parameter."""

    def __init__(
        self,
        nr_levels: int = 16,
        nr_feat_per_level: int = 2,
        log2_hashmap_size: int = 15,
        base_resolution: float = 16.0,
        growth_factor: float = 1.5,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.nr_levels = nr_levels
        self.nr_feat_per_level = nr_feat_per_level
        T = 2**log2_hashmap_size
        res = base_resolution * growth_factor ** np.arange(nr_levels)
        sizes, direct = [], []
        for r in res:
            side = int(np.floor(r)) + 2
            if side**2 <= T:
                sizes.append(side**2)
                direct.append(side)
            else:
                sizes.append(T)
                direct.append(0)
        offsets, total_rows = _level_layout(sizes)
        self.sizes = sizes
        self.total_rows = total_rows
        table = torch.empty(total_rows, nr_feat_per_level)
        with torch.no_grad():
            table.uniform_(-1e-4, 1e-4, generator=generator)
        self.table = nn.Parameter(table)
        self.register_buffer("res", torch.tensor(res.astype(np.float32)), persistent=False)
        self.register_buffer("level_off", torch.tensor(offsets, dtype=torch.int64), persistent=False)
        self.register_buffer("sizes_t", torch.tensor(sizes, dtype=torch.int64), persistent=False)
        self.register_buffer("direct_side", torch.tensor(direct, dtype=torch.int64), persistent=False)

    @property
    def output_dim(self):
        return self.nr_levels * self.nr_feat_per_level

    def lookup_indices(self, uv):
        """uv [N, 2] -> (flat_idx [N, L, 4] absolute rows, weights [N, L, 4])."""
        scaled = uv[:, None, :] * self.res[None, :, None]  # [N, L, 2]
        floor = torch.floor(scaled)
        frac = scaled - floor
        floor = floor.long()
        direct = self.direct_side[None, :]
        corner_idx, corner_w = [], []
        for corner in range(4):
            ox, oy = corner & 1, (corner >> 1) & 1
            cx = floor[..., 0] + ox
            cy = floor[..., 1] + oy
            h = _mul_u32(cx & _MASK32, _PRIMES_2D[0]) ^ _mul_u32(cy & _MASK32, _PRIMES_2D[1])
            hashed = h % self.sizes_t[None, :]
            side_max = torch.clamp(direct, min=1) - 1
            lin = torch.minimum(torch.clamp(cx, min=0), side_max) + direct * torch.minimum(
                torch.clamp(cy, min=0), side_max
            )
            corner_idx.append(torch.where(direct > 0, lin, hashed) + self.level_off[None, :])
            wx = frac[..., 0] if ox else 1.0 - frac[..., 0]
            wy = frac[..., 1] if oy else 1.0 - frac[..., 1]
            corner_w.append(wx * wy)
        return torch.stack(corner_idx, dim=-1), torch.stack(corner_w, dim=-1)

    def forward(self, uv):
        batch_shape = uv.shape[:-1]
        flat_idx, weights = self.lookup_indices(uv.reshape(-1, 2))
        feats = hash_lookup(self.table, flat_idx, weights)
        return feats.reshape(*batch_shape, self.output_dim)


class NeuralTexture(nn.Module):
    """Hash-encoded texture with anchor/lerp/bake sampling."""

    def __init__(
        self,
        res: Tuple[int, int] = (1024, 1024),  # (height, width)
        nr_channels: int = 3,
        val_range: Tuple[float, float] = (0.0, 1.0),
        anchor: bool = False,
        lerp: bool = False,
        quantize_output: bool = False,
        squeeze_output: bool = False,
        mlp_dtype: str | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.res = (int(res[0]), int(res[1]))
        self.nr_channels = nr_channels
        self.val_range = (float(val_range[0]), float(val_range[1]))
        self.anchor = anchor
        self.lerp = lerp
        self.quantize_output = quantize_output
        self.squeeze_output = squeeze_output
        self.encoding = HashGrid2D(generator=generator)
        self.network = MLP(
            self.encoding.output_dim, (64, 64, nr_channels),
            last_layer_linear=True, activation="relu", dtype=mlp_dtype,
            generator=generator,
        )

    def _texel_center_uv(self, px, py):
        """integer texel coords (x, y) -> normalized uv of the texel center."""
        H, W = self.res
        return torch.stack([(px + 0.5) / W, 1.0 - (py + 0.5) / H], dim=-1)

    def _query(self, uv):
        return self.network(self.encoding(uv))

    def _squeeze(self, out):
        out = torch.sigmoid(out)
        if self.quantize_output:
            out = round_ste(out * 255.0) / 255.0
        return out

    def _postprocess_single(self, out):
        """squeeze -> quantize -> float16 -> expand to val_range."""
        if self.squeeze_output:
            out = self._squeeze(out)
        out = out.to(torch.float16)
        if self.squeeze_output:
            lo, hi = self.val_range
            out = lo + (hi - lo) * out
        return out

    def forward(self, uv_coords, bake: bool = False):
        H, W = self.res
        if bake:
            out = self._query(uv_coords)
            return self._squeeze(out) if self.squeeze_output else out

        # continuous pixel coords with v-flip
        x = uv_coords[..., 0] * W - 0.5
        y = (1.0 - uv_coords[..., 1]) * H - 0.5

        if self.anchor:
            px = torch.clamp(torch.round(x), 0, W - 1)
            py = torch.clamp(torch.round(y), 0, H - 1)
            out = self._postprocess_single(self._query(self._texel_center_uv(px, py)))
            return out.float()

        if self.lerp:
            x0 = torch.floor(x)
            y0 = torch.floor(y)
            fx = (x - x0)[..., None]
            fy = (y - y0)[..., None]
            corners = ((0, 0), (1, 0), (0, 1), (1, 1))
            weights = ((1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy)
            # the four corners go through the texture as ONE batch of 4N uvs
            uv4 = torch.stack(
                [
                    self._texel_center_uv(
                        torch.clamp(x0 + cx, 0, W - 1), torch.clamp(y0 + cy, 0, H - 1)
                    )
                    for cx, cy in corners
                ],
                dim=0,
            )  # [4, ..., 2]
            outs = self._postprocess_single(self._query(uv4))  # [4, ..., C] f16
            # bilinear blend of OUTPUTS in float16 (WebGL filtering parity)
            out = sum(outs[c] * weights[c].to(torch.float16) for c in range(4))
            return out.float()

        raise ValueError("NeuralTexture requires anchor=True, lerp=True or bake=True")


DEG_NR_COEFFS = (1, 3, 5, 7)


class SHNeuralTextures(nn.Module):
    """Per-SH-band texture pyramid: band ``deg`` is a NeuralTexture of
    resolution deg_res[deg] with nr_channels * (2 deg + 1) outputs in
    [-sh_range[deg], sh_range[deg]]."""

    def __init__(
        self,
        sh_deg: int = 3,
        nr_channels: int = 3,
        sh_range: Sequence[float] = (1.0, 5.0, 10.0, 20.0),
        deg_res: Sequence[int] = (2048, 1024, 512, 256),
        anchor: bool = False,
        lerp: bool = True,
        quantize_output: bool = False,
        squeeze_output: bool = False,
        mlp_dtype: str | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if not 0 <= sh_deg < 4:
            raise ValueError(f"sh_deg must be in 0..3, got {sh_deg}")
        self.sh_deg = sh_deg
        self.nr_channels = nr_channels
        self.neural_textures = nn.ModuleList(
            NeuralTexture(
                res=(int(deg_res[deg]), int(deg_res[deg])),
                nr_channels=nr_channels * DEG_NR_COEFFS[deg],
                val_range=(-float(sh_range[deg]), float(sh_range[deg])),
                anchor=anchor,
                lerp=lerp,
                quantize_output=quantize_output,
                squeeze_output=squeeze_output,
                mlp_dtype=mlp_dtype,
                generator=generator,
            )
            for deg in range(sh_deg + 1)
        )

    def coeffs(self, uv_coords, bake: bool = False):
        """[N, C, (sh_deg+1)^2] SH coefficients at uv."""
        outs = []
        for deg, texture in enumerate(self.neural_textures):
            r = texture(uv_coords, bake)
            outs.append(r.reshape(*r.shape[:-1], self.nr_channels, DEG_NR_COEFFS[deg]))
        return torch.cat(outs, dim=-1)

    def forward(self, uv_coords, view_dirs=None):
        coeffs = self.coeffs(uv_coords)
        if view_dirs is None:
            return coeffs
        # SH evaluation in float16 (WebGL parity)
        raw = sh_eval(coeffs.half(), view_dirs.half(), self.sh_deg)
        return torch.sigmoid(raw.float())
