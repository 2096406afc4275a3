"""The volsurfs pair of tests/test_torch_volsurfs.py (the tiny flagship
model of __graft_entry__.py: 3 shells, sh_degree 1) with the trained
background in both packages (imports JAX), and its batch: shared by
tests/test_torch_volsurfs_bg.py and tests/test_torch_volsurfs_bg_step.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from __graft_entry__ import _tiny_volsurfs
from volsurfs_tpu.methods.volsurfs import VolSurfs as JVolSurfs
from volsurfs_tpu.ops.raycast import make_bounding_sphere as j_sphere
from volsurfs_tpu_torch.convert import params_from_jax
from volsurfs_tpu_torch.methods.volsurfs import VolSurfs
from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
from volsurfs_tpu_torch.params.hyper_params import HyperParamsVolSurfs

from _torch_offsets_pair import flax_params

N_RAYS = 128


def make_bg_pair():
    """tests/test_torch_volsurfs.py's pair (the tiny flagship model of
    __graft_entry__.py: 3 shells, sh_degree 1) with the trained background
    in both packages: the port's NerfHash (its table drawn in [-0.05, 0.05])
    carried to JAX, whose flax init of it is not run (it would compile the
    field)."""
    jwhite, jstate = _tiny_volsurfs(jax.random.PRNGKey(0))
    meshes = [(np.asarray(m.verts), np.asarray(m.faces), np.asarray(m.uvs))
              for m in jwhite.tensor_meshes]
    jmethod = JVolSurfs(jwhite.hp, meshes, bg_color=None,
                        bounding_primitive=j_sphere(1.0), key=jax.random.PRNGKey(0))
    fields = {f.name for f in dataclasses.fields(HyperParamsVolSurfs)}
    hp = HyperParamsVolSurfs(**{k: getattr(jwhite.hp, k) for k in fields})
    tmethod = VolSurfs(hp, meshes, bounding_primitive=make_bounding_sphere(1.0), device="cpu")
    rng = np.random.default_rng(4)
    bg = tmethod.models["bg"]
    with torch.no_grad():
        bg.encoder.table.copy_(torch.from_numpy(
            rng.uniform(-0.05, 0.05, tuple(bg.encoder.table.shape)).astype(np.float32)))
        # a bright background (~0.88), as the sphere scene's learns: at
        # ~0.5, the textures' own level, the shells' colours cancel it in the
        # alphas' gradients down to float16 resolution
        bg.mlp_rgb.dense_2.bias.fill_(2.0)
    params = {**jax.tree_util.tree_map(np.asarray, jstate.params),
              "bg": flax_params(tmethod.models["bg"])}
    for name, state in params_from_jax(params).items():
        tmethod.models[name].load_state_dict(state)
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    rng = np.random.default_rng(7)
    o = rng.standard_normal((N_RAYS, 3))
    o = 2.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-0.6, 0.6, (N_RAYS, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    batch = {"rays_o": o.astype(np.float32), "rays_d": d.astype(np.float32),
             "gt_rgb": rng.uniform(0.0, 1.0, (N_RAYS, 3)).astype(np.float32),
             "gt_mask": np.ones((N_RAYS, 1), np.float32)}
    return jmethod, jstate, tmethod, batch
