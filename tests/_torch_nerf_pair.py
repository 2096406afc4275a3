"""Shared set-up of the nerf parity tests (imports JAX): a JAX / port NeRF
pair with the same parameters, small widths and the full 24-level
permutohedral tables. The surf tests' helpers (tests/_torch_surf_pair.py)
serve the draws, the samples and the gradients."""

import jax
import numpy as np
import torch

from volsurfs_tpu.methods.nerf import NeRF as JNeRF
from volsurfs_tpu.ops.raycast import make_bounding_sphere as j_sphere
from volsurfs_tpu.params.hyper_params import HyperParamsNeRF as JHP
from volsurfs_tpu_torch.convert import params_from_jax
from volsurfs_tpu_torch.methods.nerf import NeRF
from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
from volsurfs_tpu_torch.params.hyper_params import HyperParamsNeRF

from _torch_offsets_pair import flax_params
from _torch_surf_pair import _flax_params

torch.set_num_threads(2)

# the sparsity term at base.cfg's weight, so that the step past its gate
# carries it; the density's coarse-to-fine window open by DATA_ITER
HP = dict(density_mlp_layers_dims=[16, 16], geom_feat_size=8, rgb_mlp_layers_dims=[32, 32],
          sh_degree=2, max_nr_samples_per_ray=16, max_nr_imp_samples_per_ray=8,
          do_importance_sampling=True, density_nr_iters_for_c2f=50, sparsity_weight=1e-4)
RES = 24
DATA_ITER = 30
R = 64
S = HP["max_nr_samples_per_ray"] + HP["max_nr_imp_samples_per_ray"]
# the sparsity term's random points: as many as the samples of R rays, so
# that JAX, run op by op, compiles the encoder's ops once for both
N_POINTS = R * S


def make_pair(bg_color="white"):
    """(JAX method, JAX params, port method) with the same parameters: the
    port's initial MLPs, tables drawn in [-0.05, 0.05] from a numpy seed,
    and the port's grid refreshed at DATA_ITER (the JAX side takes the same
    grid). With bg_color None both have the trained background (``bg``)."""
    rng = np.random.default_rng(0)
    jmethod = JNeRF(JHP(**HP), j_sphere(1.0), bg_color=bg_color, occupancy_res=RES,
                    key=jax.random.PRNGKey(0))
    method = NeRF(HyperParamsNeRF(**HP), make_bounding_sphere(1.0), bg_color=bg_color,
                  occupancy_res=RES, device="cpu")
    with torch.no_grad():
        for module in method.models.values():
            module.encoder.table.copy_(torch.from_numpy(
                rng.uniform(-0.05, 0.05, tuple(module.encoder.table.shape)).astype(np.float32)))
    params = {name: _flax_params(module) if name != "bg" else flax_params(module)
              for name, module in method.models.items()}
    for name, state in params_from_jax(params).items():  # the round trip
        method.models[name].load_state_dict(state)
    method.iter_nr = DATA_ITER
    method.update_occupancy_grid()
    return jmethod, params, method
