"""Shared set-up of the volsurfs stage's parity tests (imports JAX): the
two sphere shells of tests/test_volsurfs_e2e.py built by the JAX package's
numpy baking, its hyper-parameters, and a JAX / port VolSurfs pair with
the same parameters."""

from __future__ import annotations

import functools

import jax
import numpy as np

from volsurfs_tpu.baking.marching import extract_mesh_from_fn
from volsurfs_tpu.baking.simplify import simplify_mesh
from volsurfs_tpu.baking.uv_atlas import compute_atlas
from volsurfs_tpu.methods.volsurfs import VolSurfs as JVolSurfs
from volsurfs_tpu.ops.raycast import make_bounding_sphere as j_bounding_sphere
from volsurfs_tpu.params.hyper_params import HyperParamsVolSurfs as JHyperParams
from volsurfs_tpu_torch.convert import params_from_jax
from volsurfs_tpu_torch.methods.volsurfs import VolSurfs
from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
from volsurfs_tpu_torch.params.hyper_params import HyperParamsVolSurfs

from _stage_config import DATA, HP  # noqa: F401


@functools.lru_cache(maxsize=1)
def shell_meshes():
    """Two sphere shells (r 0.45, 0.55; inner -> outer) as (verts, faces,
    uvs), by marching, simplify and atlas."""
    meshes = []
    for radius in (0.45, 0.55):
        v, f = extract_mesh_from_fn(
            lambda p, r=radius: np.linalg.norm(p, axis=-1) - r, resolution=32)
        v, f = simplify_mesh(v, f, 0.25)
        meshes.append(compute_atlas(v, f))
    return tuple(meshes)


def port_hp(**overrides):
    return HyperParamsVolSurfs(**{**HP, **overrides})


def jax_hp(**overrides):
    return JHyperParams(**{**HP, **overrides})


def port_method(hp=None, meshes=None, seed=0):
    return VolSurfs(hp or port_hp(), list(meshes or shell_meshes()), bg_color="white",
                    bounding_primitive=make_bounding_sphere(1.0), device="cpu", seed=seed)


def textured_jax_pair(seed=0, **overrides):
    """(JAX method, JAX state, port method) with the same parameters: JAX's
    initial MLPs, and hash tables drawn from a numpy seed in [-1, 1] so
    that the textures vary across the uv square (the initial tables, within
    1e-4 of 0, give a near-constant 0.5 everywhere)."""
    rng = np.random.default_rng(seed)
    jmethod = JVolSurfs(jax_hp(**overrides), list(shell_meshes()), bg_color="white",
                        bounding_primitive=j_bounding_sphere(1.0), key=jax.random.PRNGKey(seed))
    state = jmethod.init_state()
    params = jax.tree_util.tree_map(np.array, state.params)
    for sub in params.values():
        for name, tex in sub["params"].items():
            table = tex["encoding"]["table"]
            tex["encoding"]["table"] = rng.uniform(-1.0, 1.0, table.shape).astype(np.float32)
    state = state.replace(params=jax.tree_util.tree_map(jax.numpy.asarray, params))
    tmethod = port_method(port_hp(**overrides))
    for name, torch_state in params_from_jax(params).items():
        tmethod.models[name].load_state_dict(torch_state)
    return jmethod, state, tmethod

