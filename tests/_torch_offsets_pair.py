"""Shared set-up of the offsets_surfs parity tests (imports JAX): a JAX /
port OffsetsSurfs pair with the same parameters, small widths, the full
24-level permutohedral tables and K = 5 surfaces (3 inner, 1 outer, so
that both kinds of eps head take part)."""

import jax
import numpy as np
import torch

from volsurfs_tpu.methods.offsets_surfs import OffsetsSurfs as JOffsetsSurfs
from volsurfs_tpu.ops.raycast import make_bounding_sphere as j_sphere
from volsurfs_tpu.params.hyper_params import HyperParamsOffsetsSuRFs as JHP
from volsurfs_tpu_torch.convert import params_from_jax
from volsurfs_tpu_torch.methods.offsets_surfs import OffsetsSurfs
from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
from volsurfs_tpu_torch.params.hyper_params import HyperParamsOffsetsSuRFs

torch.set_num_threads(2)

HP = dict(sdf_mlp_layers_dims=[16, 16], geom_feat_size=8, rgb_mlp_layers_dims=[32, 32],
          sh_degree=2, max_nr_samples_per_ray=16, max_nr_imp_samples_per_ray=8,
          do_importance_sampling=True, init_phase_end_iter=10, color_init_phase_end_iter=20,
          first_phase_end_iter=100, sdf_nr_iters_for_c2f=0, nr_inner_surfs=3,
          nr_outer_surfs=1, eikonal_weight=0.04, support_surfs_eikonal_weight=0.04,
          curvature_weight=0.65, offsurface_weight=1e-4)
RES = 24
DATA_ITER = 30  # in the first phase; the grid is refreshed there
# an iteration of each phase
PHASE_ITERS = {"offsets_init": 5, "color_init": 15, "first": DATA_ITER, "second": 120}
R = 64
S = HP["max_nr_samples_per_ray"] + HP["max_nr_imp_samples_per_ray"]
# the random points of the train steps: as many as the samples of R rays,
# so that JAX, run op by op, compiles the encoders' ops once for both
N_POINTS = R * S

# the port's submodule names and flax's (NerfHash's rgb head is its MLP_1)
_FLAX_NAMES = {"encoder": "PermutoEncoder_0", "mlp": "MLP_0", "mlp_rgb": "MLP_1"}


def flax_params(module):
    """A port module's parameters as the flax tree of its JAX counterpart
    (``convert.params_from_jax`` inverts this): RGB's ``encoder`` and
    ``mlp`` are flax's automatic names, OffsetsSDF's keep theirs."""
    tree = {}
    for name, p in module.named_parameters():
        parts = [_FLAX_NAMES.get(x, x) for x in name.split(".")]
        value = p.detach().numpy().copy()
        if parts[-1] == "weight":
            parts[-1], value = "kernel", value.T.copy()
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return {"params": tree}


def make_pair(bg_color="white"):
    """(JAX method, JAX params, port method) with the same parameters: the
    port's initial MLPs, tables drawn in [-0.05, 0.05] from a numpy seed,
    and the port's grid refreshed at DATA_ITER (the JAX side takes the same
    grid). With bg_color None both have the trained background (``bg``)."""
    rng = np.random.default_rng(0)
    jmethod = JOffsetsSurfs(JHP(**HP), j_sphere(1.0), bg_color=bg_color, occupancy_res=RES,
                            key=jax.random.PRNGKey(0))
    method = OffsetsSurfs(HyperParamsOffsetsSuRFs(**HP), make_bounding_sphere(1.0),
                          bg_color=bg_color, occupancy_res=RES, device="cpu")
    with torch.no_grad():
        for name, p in method.models.named_parameters():
            if name.endswith("table"):
                p.copy_(torch.from_numpy(rng.uniform(-0.05, 0.05, tuple(p.shape))
                                         .astype(np.float32)))
    params = {name: flax_params(module) for name, module in method.models.items()}
    for name, state in params_from_jax(params).items():  # the round trip
        method.models[name].load_state_dict(state)
    method.iter_nr = DATA_ITER
    method.update_occupancy_grid()
    return jmethod, params, method


def flat_grads(tree, prefix=""):
    """A flax gradient tree by the port's parameter names."""
    inverse = {v: k for k, v in _FLAX_NAMES.items()}
    out = {}
    for key, value in tree.items():
        if key == "params":
            out.update(flat_grads(value, prefix))
            continue
        name = f"{prefix}.{inverse.get(key, key)}" if prefix else inverse.get(key, key)
        if isinstance(value, dict):
            out.update(flat_grads(value, name))
        elif key == "kernel":
            out[name[:-len("kernel")] + "weight"] = np.asarray(value).T
        else:
            out[name] = np.asarray(value)
    return out


def port_grads(method):
    """The port's gradients by name (zeros where the loss does not reach a
    parameter, as JAX's)."""
    return {f"{name}.{k}": p.grad.numpy().copy() if p.grad is not None else np.zeros(p.shape)
            for name, m in method.models.items() for k, p in m.named_parameters()}
