"""Carry parameters of a JAX ``VolSurfs`` over to the port.

``volsurfs_params_from_jax`` takes ``TrainState.params`` of the JAX method
as a nested dict of numpy arrays ({"rgb_0": {"params": {...}}, ...}) and
returns one state dict per port module (``rgb_{i}``, ``alpha_{i}``), ready
for ``VolSurfs.models[name].load_state_dict``. Flax ``Dense`` kernels are
[in, out] and torch ``Linear`` weights [out, in], so they are transposed;
hash-table rows keep their order.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict):
            yield from _flatten(value, name)
        else:
            yield name, value


def _torch_name(flax_name: str) -> str:
    """neural_textures_0.network.dense_1.kernel ->
    neural_textures.0.network.dense_1.weight"""
    parts = []
    for part in flax_name.split("."):
        if part.startswith("neural_textures_"):
            parts += ["neural_textures", part[len("neural_textures_"):]]
        elif part == "kernel":
            parts.append("weight")
        else:
            parts.append(part)
    return ".".join(parts)


def module_state_from_flax(flax_params: dict) -> dict:
    """One flax module's {"params": {...}} -> a torch state dict."""
    tree = flax_params.get("params", flax_params)
    state = {}
    for name, value in _flatten(tree):
        value = np.array(value, np.float32)  # a writable copy
        if name.endswith(".kernel"):
            value = np.ascontiguousarray(value.T)
        state[_torch_name(name)] = torch.from_numpy(value)
    return state


def volsurfs_params_from_jax(params_np: dict) -> dict:
    """{"rgb_0": flax params, ...} -> {"rgb_0": torch state dict, ...}."""
    return {name: module_state_from_flax(sub) for name, sub in params_np.items()}
