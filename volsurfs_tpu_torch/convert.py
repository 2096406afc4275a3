"""Carry parameters of a JAX ``Surf``, ``NeRF``, ``OffsetsSurfs`` or
``VolSurfs`` over to the port (the trained background ``bg`` included).

``params_from_jax`` takes ``TrainState.params`` of the JAX method as a
nested dict of numpy arrays ({"sdf": {"params": {...}}, "rgb": ...};
{"density": ..., "rgb": ...}; {"sdfs": ..., "rgb_0": ..., "alpha_0": ...})
and returns one state dict per port module, ready for
``method.models[name].load_state_dict``. Flax
``Dense`` kernels are [in, out] and torch ``Linear`` weights [out, in], so
they are transposed; hash-table rows keep their order. Flax's automatic
submodule names become the port's attribute names (``PermutoEncoder_0`` ->
``encoder``, ``MLP_0`` -> ``mlp``, ``MLP_1`` -> ``mlp_rgb``, NerfHash's rgb
head); ``OffsetsSDF``'s ``setup()`` names
(``pos_encoder``, ``mlp_sdf``, ``mlp_eps_{i}``) are the port's as they are.
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


# NerfHash's second MLP (its rgb head) is flax's MLP_1
_SUBMODULES = {"PermutoEncoder_0": "encoder", "MLP_0": "mlp", "MLP_1": "mlp_rgb"}


def _torch_name(flax_name: str) -> str:
    """neural_textures_0.network.dense_1.kernel ->
    neural_textures.0.network.dense_1.weight; MLP_0.dense_0.kernel ->
    mlp.dense_0.weight"""
    parts = []
    for part in flax_name.split("."):
        if part.startswith("neural_textures_"):
            parts += ["neural_textures", part[len("neural_textures_"):]]
        elif part == "kernel":
            parts.append("weight")
        else:
            parts.append(_SUBMODULES.get(part, part))
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


def params_from_jax(params_np: dict) -> dict:
    """{"rgb_0": flax params, ...} -> {"rgb_0": torch state dict, ...}."""
    return {name: module_state_from_flax(sub) for name, sub in params_np.items()}
