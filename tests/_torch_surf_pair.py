"""Shared set-up of the surf parity tests (imports JAX): a JAX / port Surf
pair with the same parameters, small widths and the full 24-level
permutohedral tables, and the means to feed both the same random draws
and the same samples."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from volsurfs_tpu.methods.surf import Surf as JSurf
from volsurfs_tpu.models import encodings as JE
from volsurfs_tpu.ops import samples as JS
from volsurfs_tpu.ops.raycast import make_bounding_sphere as j_sphere
from volsurfs_tpu.params.hyper_params import HyperParamsSuRF as JHP
from volsurfs_tpu_torch.convert import params_from_jax
from volsurfs_tpu_torch.methods.surf import Surf
from volsurfs_tpu_torch.ops.occupancy import OccupancyGrid
from volsurfs_tpu_torch.ops.raycast import BoundingSphere, make_bounding_sphere
from volsurfs_tpu_torch.params.hyper_params import HyperParamsSuRF

torch.set_num_threads(2)

HP = dict(appearance_predict_sh_coeffs=True, sdf_mlp_layers_dims=[16, 16], geom_feat_size=8,
          rgb_mlp_layers_dims=[32, 32], sh_degree=2, max_nr_samples_per_ray=16,
          max_nr_imp_samples_per_ray=8, do_importance_sampling=True, init_phase_end_iter=10,
          first_phase_end_iter=100, sdf_nr_iters_for_c2f=50, eikonal_weight=0.04,
          curvature_weight=0.65, offsurface_weight=1e-4)
RES = 24
DATA_ITER = 30
R = 64
# the random points of the train steps: as many as the samples of R rays,
# so that JAX, run op by op, compiles the encoder's ops once for both
N_POINTS = R * (HP["max_nr_samples_per_ray"] + HP["max_nr_imp_samples_per_ray"])


def _flax_params(module):
    """A port field's parameters as the flax tree of its JAX counterpart
    (``convert.params_from_jax`` inverts this)."""
    tree = {"PermutoEncoder_0": {"table": module.encoder.table.detach().numpy().copy()},
            "MLP_0": {}}
    for i in range(module.mlp.nr_layers):
        layer = getattr(module.mlp, f"dense_{i}")
        tree["MLP_0"][f"dense_{i}"] = {"kernel": layer.weight.detach().numpy().T.copy(),
                                       "bias": layer.bias.detach().numpy().copy()}
    return {"params": tree}


def make_pair(bg_color="white", hp=None):
    """(JAX method, JAX params, port method) with the same parameters: the
    port's initial MLPs, tables drawn in [-0.05, 0.05] from a numpy seed
    (flax's init is not run: it would compile both fields), and the port's
    grid refreshed at DATA_ITER (the JAX side takes the same grid). With
    bg_color None both have the trained background (``bg``)."""
    from _torch_offsets_pair import flax_params

    rng = np.random.default_rng(0)
    hp = {**HP, **(hp or {})}
    jmethod = JSurf(JHP(**hp), j_sphere(1.0), bg_color=bg_color, occupancy_res=RES,
                    key=jax.random.PRNGKey(0))
    method = Surf(HyperParamsSuRF(**hp), make_bounding_sphere(1.0), bg_color=bg_color,
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


def jax_grid(jmethod, grid: OccupancyGrid):
    from volsurfs_tpu.ops.occupancy import OccupancyGrid as JGrid

    return JGrid(values=jnp.asarray(grid.values.numpy()),
                 occupancy=jnp.asarray(grid.occupancy.numpy()),
                 roi=jnp.asarray(grid.roi.numpy()), extent=jnp.asarray(grid.extent))


def camera_rays(seed, n=R):
    rng = np.random.default_rng(seed)
    o = np.tile(np.float32([[0.0, 0.0, -2.0]]), (n, 1))
    d = rng.normal(0, 0.25, (n, 3)).astype(np.float32) + np.float32([0, 0, 1])
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


class Draws:
    """The same random numbers for both packages, served in the order both
    draw them: (the shape JAX asks for, the array served); port_only draws
    go to the port alone, first. JAX's other draws (flax checks a
    parameter's initializer by tracing it) go to the real functions."""

    def __init__(self, requests, port_only=()):
        self.jax_queue = list(requests)
        self.port_queue = list(port_only) + [a for _, a in requests]

    def jax_fn(self, real):
        def draw(key, shape=(), *args, **kwargs):
            if self.jax_queue and tuple(shape) == self.jax_queue[0][0]:
                return jnp.asarray(self.jax_queue.pop(0)[1])
            return real(key, shape, *args, **kwargs)
        return draw

    def port_fn(self, *args):
        return torch.from_numpy(self.port_queue.pop(0))


def feed(monkeypatch, method, draws):
    monkeypatch.setattr(jax.random, "normal", draws.jax_fn(jax.random.normal))
    monkeypatch.setattr(jax.random, "uniform", draws.jax_fn(jax.random.uniform))
    monkeypatch.setattr(method, "_uniform", draws.port_fn)
    if hasattr(method, "_normal"):  # nerf draws no normals
        monkeypatch.setattr(method, "_normal", draws.port_fn)
    monkeypatch.setattr(BoundingSphere, "get_random_points_inside",
                        lambda self, gen, n: self.points_from_draws(draws.port_fn(),
                                                                    draws.port_fn()))


def share_samples(monkeypatch, method, jmethod):
    """JAX's _sample_rays returns the samples the port's last took (the
    samplers' parity is test_torch_samplers.py's and the render's here),
    so that both evaluate the fields at the same points."""
    taken = {}
    sample = method._sample_rays

    def port(*args, **kwargs):
        taken["samples"] = out = sample(*args, **kwargs)
        return out

    def jax_side(*args, **kwargs):
        s = taken["samples"]
        return JS.RaySamples(**{f: jnp.asarray(getattr(s, f).numpy()) for f in (
            "z", "dt", "mask", "rays_o", "rays_d", "t_near", "t_far", "max_dt")})

    monkeypatch.setattr(method, "_sample_rays", port)
    monkeypatch.setattr(jmethod, "_sample_rays", jax_side)


def port_grads(method):
    """The port's gradients by JAX's names (zeros where the loss does not
    reach a parameter, as JAX's)."""
    return {f"{name}.{k}": p.grad.numpy().copy() if p.grad is not None else np.zeros(p.shape)
            for name, m in method.models.items() for k, p in m.named_parameters()}


def jax_grads(grads, names=("sdf", "rgb")):
    from _torch_offsets_pair import flat_grads

    flat = {f"bg.{k}": v for k, v in flat_grads(grads["bg"]).items()} if "bg" in grads else {}
    for name in names:
        tree = grads[name]["params"]
        flat[f"{name}.encoder.table"] = np.asarray(tree["PermutoEncoder_0"]["table"])
        for layer, v in tree["MLP_0"].items():
            flat[f"{name}.mlp.{layer}.weight"] = np.asarray(v["kernel"]).T
            flat[f"{name}.mlp.{layer}.bias"] = np.asarray(v["bias"])
    return flat


def compare(got_loss, ref_loss, method, ref_grads, tol):
    for k in ref_loss:
        if k in got_loss and not k.startswith("grad_norm"):
            np.testing.assert_allclose(float(got_loss[k]), float(ref_loss[k]),
                                       rtol=tol["losses"], atol=1e-9, err_msg=k)
    got = port_grads(method)
    assert set(got) == set(ref_grads)
    for k, ref in ref_grads.items():
        err = np.linalg.norm(got[k] - ref) / max(np.linalg.norm(ref), 1e-12)
        bound = tol["grads"](k)
        assert err <= bound, (k, err, bound)


def jax_value_and_grad(loss_fn, params):
    prev = JE._TABLE_GRAD_MODE
    JE.set_table_grad_mode("flat")
    try:
        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    finally:
        JE.set_table_grad_mode(prev)
    return losses, grads
