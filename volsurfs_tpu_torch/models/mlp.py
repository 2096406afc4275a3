"""Linear + activation stack (counterpart of volsurfs_tpu/models/mlp.py::MLP;
``LipshitzMLP`` waits for the surf slice)."""

from __future__ import annotations

from typing import Sequence

import math

import torch
from torch import nn
from torch.nn import functional as F

_ACTIVATIONS = {
    # flax's nn.gelu is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def lecun_normal_(weight, generator=None):
    """flax's default Dense init: truncated normal (+-2 std), variance
    1/fan_in. weight is [out, in]."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class MLP(nn.Module):
    """Linear layers ``dense_{i}`` with an activation between them; the last
    layer is linear when last_layer_linear. dtype "bfloat16" computes the
    layers in bf16 (parameters stay f32) and returns f32."""

    def __init__(
        self,
        in_dim: int,
        layer_dims: Sequence[int],
        last_layer_linear: bool = True,
        activation: str = "gelu",
        dtype: str | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.activation = _ACTIVATIONS[activation]
        self.last_layer_linear = last_layer_linear
        self.compute_dtype = None if dtype is None else getattr(torch, dtype)
        self.nr_layers = len(layer_dims)
        dim = in_dim
        for i, out in enumerate(layer_dims):
            layer = nn.Linear(dim, out)
            with torch.no_grad():
                lecun_normal_(layer.weight, generator)
                layer.bias.zero_()
            self.add_module(f"dense_{i}", layer)
            dim = out

    def forward(self, x):
        for i in range(self.nr_layers):
            layer = getattr(self, f"dense_{i}")
            if self.compute_dtype is None:
                x = layer(x)
            else:
                dt = self.compute_dtype
                x = F.linear(x.to(dt), layer.weight.to(dt), layer.bias.to(dt))
            if not (i == self.nr_layers - 1 and self.last_layer_linear):
                x = self.activation(x)
        return x if self.compute_dtype is None else x.float()
