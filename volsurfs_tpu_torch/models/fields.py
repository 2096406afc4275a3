"""Neural fields of the surf, offsets_surfs and nerf methods: ``SDF``,
``OffsetsSDF``, ``Density``, ``RGB``, ``ColorSH`` and the background's
``NerfHash`` (counterpart of volsurfs_tpu/models/fields.py:24-412; RGB's
``LipshitzMLP`` waits for ROADMAP.md Queue 1 item 5, part 2).

Submodules keep the flax names' order: ``encoder`` is flax's
``PermutoEncoder_0``, ``mlp`` its ``MLP_0`` and ``mlp_rgb`` its ``MLP_1``
(``convert.py``);
``OffsetsSDF``'s submodules carry its flax ``setup()`` names as they are
(``pos_encoder``, ``mlp_sdf``, ``mlp_eps_{i}``)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from volsurfs_tpu_torch.models.encodings import get_encoder
from volsurfs_tpu_torch.models.mlp import MLP
from volsurfs_tpu_torch.ops.sh import num_sh_coeffs, sh_basis, sh_eval
from volsurfs_tpu_torch.utils.math import small_cumsum, take_rev


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


def _softplus(x):
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


class OffsetsSDF(nn.Module):
    """Main SDF + k offset level-set heads -> (sdfs [..., K, 1], offsets
    [..., K, 1], geom_feats), K = nr_inner_surfs + 1 + nr_outer_surfs
    surfaces ordered inner...main...outer. Each eps head is a small MLP on
    the geometry features, softplus-positive for the inner surfaces and
    negative for the outer, summed cumulatively so that the offsets stay
    ordered, with a min_offset margin. ``train_main_surf=False`` detaches
    the main head's outputs, ``train_offsets=False`` the eps heads', where
    JAX stops their gradients."""

    def __init__(self, mlp_layers_dims: Sequence[int] = (32, 32, 32),
                 encoding_type: str = "permutohash", nr_inner_surfs: int = 1,
                 nr_outer_surfs: int = 1, geom_feat_size: int = 32, min_offset: float = 1e-4,
                 nr_iters_for_c2f: int = 0, bb_sides: float = 2.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.nr_inner_surfs, self.nr_outer_surfs = nr_inner_surfs, nr_outer_surfs
        self.nr_surfs = nr_inner_surfs + nr_outer_surfs + 1
        self.main_surf_idx = nr_inner_surfs
        self.geom_feat_size, self.min_offset = geom_feat_size, min_offset
        self.pos_encoder = get_encoder(encoding_type, generator=generator, input_dim=3,
                                       nr_levels=24, nr_iters_for_c2f=nr_iters_for_c2f,
                                       bb_sides=bb_sides)
        self.mlp_sdf = MLP(self.pos_encoder.output_dim,
                           tuple(mlp_layers_dims) + (1 + geom_feat_size,),
                           last_layer_linear=True, generator=generator)
        # one eps head a surface other than the main one (JAX's
        # use_per_offset_mlp, which every config leaves on)
        for i in range(self.nr_surfs - 1):
            self.add_module(f"mlp_eps_{i}", MLP(geom_feat_size, (32, 1), last_layer_linear=True,
                                                generator=generator))

    def _split(self, pred):
        return pred[..., 0:1], pred[..., 1:] if self.geom_feat_size > 0 else None

    def main_sdf(self, points, iter_nr=None, train_main_surf: bool = True):
        """(sdf [..., 1], geom_feats) of the main surface."""
        feats, _ = self.pos_encoder(points, iter_nr)
        pred = self.mlp_sdf(feats)
        return self._split(pred if train_main_surf else pred.detach())

    def main_sdf_grad(self, points, iter_nr=None, train_main_surf: bool = True):
        """The main surface's analytic spatial gradient [..., 3] alone (the
        curvature term's), without the eps heads' tangents."""
        feats, dfeats, _ = self.pos_encoder(points, iter_nr, with_grads=True)
        _, dpred = self.mlp_sdf(feats, tangents=dfeats)
        if not train_main_surf:
            dpred = dpred.detach()
        return torch.movedim(dpred[..., 0], 0, -1)

    def _offsets(self, geom_feats, train_offsets: bool, dgeom=None):
        """(cum_inner_eps, cum_outer_eps, inner_eps, outer_eps, dcum_inner,
        dcum_outer): the eps heads' offsets, and with the geometry
        features' tangents dgeom [3, ..., F] the cumulative offsets'
        tangents [3, ..., n] (the chain rule through the heads; None
        without dgeom)."""
        heads = [getattr(self, f"mlp_eps_{i}") for i in range(self.nr_surfs - 1)]
        if dgeom is None:
            eps, deps = torch.cat([m(geom_feats) for m in heads], dim=-1), None
        else:
            pairs = [m(geom_feats, tangents=dgeom) for m in heads]
            eps = torch.cat([p[0] for p in pairs], dim=-1)
            deps = torch.cat([p[1] for p in pairs], dim=-1)
        if not train_offsets:
            eps = eps.detach()
            deps = None if deps is None else deps.detach()
        n_out = self.nr_outer_surfs
        inner_eps = _softplus(eps[..., n_out:])
        outer_eps = -_softplus(eps[..., :n_out])
        cum_outer = small_cumsum(outer_eps, -1) - self.min_offset
        cum_inner = take_rev(small_cumsum(inner_eps, -1) + self.min_offset, -1)
        if deps is None:
            return cum_inner, cum_outer, inner_eps, outer_eps, None, None
        sig = torch.sigmoid(eps)  # softplus'
        dcum_inner = take_rev(small_cumsum(sig[None, ..., n_out:] * deps[..., n_out:], -1), -1)
        dcum_outer = small_cumsum(-sig[None, ..., :n_out] * deps[..., :n_out], -1)
        return cum_inner, cum_outer, inner_eps, outer_eps, dcum_inner, dcum_outer

    def get_offsets(self, geom_feats, train_offsets: bool = True):
        """(cum_inner_eps, cum_outer_eps, inner_eps, outer_eps)."""
        return self._offsets(geom_feats, train_offsets)[:4]

    def forward(self, points, iter_nr=None, train_main_surf: bool = True,
                train_offsets: bool = True, with_grads: bool = False):
        """(sdfs [..., K, 1], offsets [..., K, 1], geom_feats), and with
        with_grads also sdfs_grad [..., K, 3]: every surface's analytic
        spatial gradient, the encoder's Jacobian carried through the main
        head and the eps heads as tangents (one table-gradient scatter)."""
        if with_grads:
            feats, dfeats, _ = self.pos_encoder(points, iter_nr, with_grads=True)
            pred, dpred = self.mlp_sdf(feats, tangents=dfeats)  # dpred [3, ..., out]
            if not train_main_surf:
                pred, dpred = pred.detach(), dpred.detach()
            sdf, geom_feats = self._split(pred)
            g = dpred[..., 0:1]  # [3, ..., 1]: the 3 spatial rows lead until the end
        else:
            sdf, geom_feats = self.main_sdf(points, iter_nr, train_main_surf)
            g = None
        if self.nr_surfs == 1:
            sdfs, offsets = sdf[..., None, :], None
        else:
            cum_inner, cum_outer, inner_eps, outer_eps, dcum_inner, dcum_outer = self._offsets(
                geom_feats, train_offsets, None if g is None else dpred[..., 1:])
            sdfs = torch.cat([sdf + cum_inner, sdf, sdf + cum_outer], dim=-1)[..., None]
            offsets = torch.cat([inner_eps, torch.zeros_like(sdf), outer_eps], dim=-1)[..., None]
            if g is not None:
                g = torch.cat([g + dcum_inner, g, g + dcum_outer], dim=-1)
        if g is None:
            return sdfs, offsets, geom_feats
        return sdfs, offsets, geom_feats, torch.movedim(g, 0, -1)


class Density(nn.Module):
    """Position encoder + MLP -> (softplus density [..., 1], geom_feats
    [..., G]): the nerf method's geometry, the SDF's layers with a softplus
    on the first output."""

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

    def forward(self, points, iter_nr=None):
        feats, _ = self.encoder(points, iter_nr)
        pred = self.mlp(feats)
        return _softplus(pred[..., 0:1]), pred[..., 1:] if self.geom_feat_size > 0 else None


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
            raise NotImplementedError(
                "LipshitzMLP is not ported (ROADMAP.md Queue 1 item 5, part 2)")
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
        return self.forward_surfaces(points, samples_dirs,
                                     None if normals is None else normals[None], geom_feat,
                                     iter_nr)[0]

    def forward_surfaces(self, points, samples_dirs, normals, geom_feat=None, iter_nr=None):
        """The field at the same points for K surfaces that differ only in
        their normals [K, ..., 3] (K = 1 without normals): [K, ..., out].
        The position encoding and the direction basis are computed once and
        the K inputs go through the MLP as one batch; the result equals K
        calls of forward but for float32 rounding, and the table's gradient
        is one sum."""
        K = 1 if normals is None else normals.shape[0]
        shared = []
        if self.encoder is not None:
            shared.append(self.encoder(points, iter_nr)[0])
        if self.view_dep:
            # the direction encoding carries no gradient
            shared.append(sh_basis(samples_dirs, self.sh_deg).detach())
        data = [x.expand(K, *x.shape) for x in shared]
        if self.normal_dep:
            data.append(normals)
        if self.geom_feat_dep:
            data.append(geom_feat.expand(K, *geom_feat.shape))
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


class NerfHash(nn.Module):
    """The background field over the contracted space: position encoding
    (24 levels, the points as they are with ``bb_sides=None``) -> MLP
    64-64-64-(64 + 1) -> softplus density and 64 features; [gelu(features),
    the SH basis of the direction (no gradient)] -> MLP 64-64-3 -> sigmoid
    rgb. Returns (rgb [..., 3], density [..., 1])."""

    def __init__(self, pos_encoder_type: str = "permutohash", sh_deg: int = 3,
                 nr_feat_for_rgb: int = 64, nr_iters_for_c2f: int = 0, bb_sides=2.0,
                 mlp_dtype: str | None = None, generator: torch.Generator | None = None):
        super().__init__()
        self.sh_deg = sh_deg
        self.nr_feat_for_rgb = nr_feat_for_rgb
        self.encoder = get_encoder(pos_encoder_type, generator=generator, input_dim=3,
                                   nr_levels=24, nr_iters_for_c2f=nr_iters_for_c2f,
                                   bb_sides=bb_sides)
        self.mlp = MLP(self.encoder.output_dim, (64, 64, 64, nr_feat_for_rgb + 1),
                       last_layer_linear=True, dtype=mlp_dtype, generator=generator)
        self.mlp_rgb = MLP(nr_feat_for_rgb + num_sh_coeffs(sh_deg), (64, 64, 3),
                           last_layer_linear=True, dtype=mlp_dtype, generator=generator)

    def forward(self, points, samples_dirs, iter_nr=None):
        feats, _ = self.encoder(points, iter_nr)
        dirs_enc = sh_basis(samples_dirs, self.sh_deg).detach()
        feat_and_density = self.mlp(feats)
        density = _softplus(feat_and_density[..., 0:1])
        feat_rgb = feat_and_density[..., 1:self.nr_feat_for_rgb + 1]
        x = torch.cat([F.gelu(feat_rgb, approximate="tanh"), dirs_enc], dim=-1)
        return torch.sigmoid(self.mlp_rgb(x)), density
