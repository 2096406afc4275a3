"""Neural fields of the surf method: ``SDF``, ``RGB`` and ``ColorSH``
(counterpart of volsurfs_tpu/models/fields.py:24-65 and :273-375; RGB's
``LipshitzMLP``, ``OffsetsSDF`` and ``NerfHash`` wait for their ROADMAP.md
Queue 1 items).

Submodules keep the flax names' order: ``encoder`` is flax's
``PermutoEncoder_0`` and ``mlp`` its ``MLP_0`` (``convert.py``)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from volsurfs_tpu_torch.models.encodings import get_encoder
from volsurfs_tpu_torch.models.mlp import MLP
from volsurfs_tpu_torch.ops.sh import num_sh_coeffs, sh_basis, sh_eval


class SDF(nn.Module):
    """Position encoder + MLP -> (sdf [..., 1], geom_feats [..., G])."""

    def __init__(self, mlp_layers_dims: Sequence[int] = (32, 32, 32),
                 encoding_type: str = "permutohash", geom_feat_size: int = 32,
                 nr_iters_for_c2f: int = 0, bb_sides: float = 2.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.geom_feat_size = geom_feat_size
        self.encoder = get_encoder(encoding_type, generator=generator, input_dim=3,
                                   nr_levels=24, nr_iters_for_c2f=nr_iters_for_c2f,
                                   bb_sides=bb_sides)
        self.mlp = MLP(self.encoder.output_dim, tuple(mlp_layers_dims) + (1 + geom_feat_size,),
                       last_layer_linear=True, generator=generator)

    def forward(self, points, iter_nr=None, with_grads: bool = False):
        """(sdf, geom_feats), or with with_grads (sdf, geom_feats, sdf_grad
        [..., 3]): the encoder's Jacobian carried through the MLP as
        tangents (one table-gradient scatter for both)."""
        if not with_grads:
            feats, _ = self.encoder(points, iter_nr)
            return self._split(self.mlp(feats))
        feats, dfeats, _ = self.encoder(points, iter_nr, with_grads=True)
        pred, dpred = self.mlp(feats, tangents=dfeats)  # dpred [3, ..., out]
        return (*self._split(pred), torch.movedim(dpred[..., 0], 0, -1))

    def _split(self, pred):
        return pred[..., 0:1], pred[..., 1:] if self.geom_feat_size > 0 else None


class RGB(nn.Module):
    """[position encoding, SH basis of the view direction, normal, geometry
    feature] -> MLP -> sigmoid rgb."""

    def __init__(self, mlp_layers_dims: Sequence[int] = (128, 128, 64),
                 pos_encoder_type: str = "permutohash", out_channels: int = 3, sh_deg: int = 3,
                 pos_dep: bool = True, view_dep: bool = True, normal_dep: bool = True,
                 geom_feat_dep: bool = True, in_geom_feat_size: int = 32,
                 nr_iters_for_c2f: int = 0, use_lipshitz_mlp: bool = False,
                 bb_sides: float = 2.0, mlp_dtype: str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if use_lipshitz_mlp:
            raise NotImplementedError("LipshitzMLP is not ported (ROADMAP.md Queue 1 item 5)")
        self.sh_deg, self.view_dep, self.normal_dep = sh_deg, view_dep, normal_dep
        self.geom_feat_dep = geom_feat_dep and in_geom_feat_size > 0
        self.encoder = None
        in_dim = 0
        if pos_dep:
            self.encoder = get_encoder(pos_encoder_type, generator=generator, input_dim=3,
                                       nr_levels=24, nr_iters_for_c2f=nr_iters_for_c2f,
                                       bb_sides=bb_sides)
            in_dim += self.encoder.output_dim
        in_dim += ((num_sh_coeffs(sh_deg) if view_dep else 0) + (3 if normal_dep else 0)
                   + (in_geom_feat_size if self.geom_feat_dep else 0))
        self.mlp = MLP(in_dim, tuple(mlp_layers_dims) + (out_channels,), last_layer_linear=True,
                       dtype=mlp_dtype, generator=generator)

    def forward(self, points=None, samples_dirs=None, normals=None, geom_feat=None, iter_nr=None):
        data = []
        if self.encoder is not None:
            data.append(self.encoder(points, iter_nr)[0])
        if self.view_dep:
            # the direction encoding carries no gradient
            data.append(sh_basis(samples_dirs, self.sh_deg).detach())
        if self.normal_dep:
            data.append(normals)
        if self.geom_feat_dep:
            data.append(geom_feat)
        return torch.sigmoid(self.mlp(torch.cat(data, dim=-1)))


class ColorSH(nn.Module):
    """Position (+ normal, + geometry feature) -> MLP -> SH coefficients,
    evaluated at the view directions and squashed by a sigmoid (the raw
    coefficients without directions)."""

    def __init__(self, mlp_layers_dims: Sequence[int] = (128, 128, 64),
                 pos_encoder_type: str = "permutohash", out_channels: int = 3, sh_deg: int = 3,
                 normal_dep: bool = True, geom_feat_dep: bool = True,
                 in_geom_feat_size: int = 32, nr_iters_for_c2f: int = 0, bb_sides: float = 2.0,
                 mlp_dtype: str | None = None, generator: torch.Generator | None = None):
        super().__init__()
        self.out_channels, self.sh_deg = out_channels, sh_deg
        self.normal_dep = normal_dep
        self.geom_feat_dep = geom_feat_dep and in_geom_feat_size > 0
        self.encoder = get_encoder(pos_encoder_type, generator=generator, input_dim=3,
                                   nr_levels=24, nr_iters_for_c2f=nr_iters_for_c2f,
                                   bb_sides=bb_sides)
        in_dim = (self.encoder.output_dim + (3 if normal_dep else 0)
                  + (in_geom_feat_size if self.geom_feat_dep else 0))
        self.mlp = MLP(in_dim, tuple(mlp_layers_dims) + (num_sh_coeffs(sh_deg) * out_channels,),
                       last_layer_linear=True, dtype=mlp_dtype, generator=generator)

    def forward(self, points, samples_dirs=None, normals=None, geom_feat=None, iter_nr=None):
        feats, _ = self.encoder(points, iter_nr)
        data = [feats]
        if self.normal_dep:
            data.append(normals)
        if self.geom_feat_dep:
            data.append(geom_feat)
        pred = self.mlp(torch.cat(data, dim=-1))
        if samples_dirs is None:
            return pred
        sh_coeffs = pred.reshape(*pred.shape[:-1], self.out_channels, num_sh_coeffs(self.sh_deg))
        return torch.sigmoid(sh_eval(sh_coeffs, samples_dirs, self.sh_deg))
