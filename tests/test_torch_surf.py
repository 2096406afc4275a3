"""Parity of the port's surf fields and render with volsurfs_tpu's: the SDF,
ColorSH and RGB fields on converted parameters, the volumetric render
(Surf.render_rays, train=False) on the same occupancy grid, and a JAX
checkpoint loaded into the port, for the pair of tests/_torch_surf_pair.py
(small widths, the full 24-level permutohedral tables). JAX runs op by op.

Tolerances: the fields 1e-5 (float32 rounding). The render 1e-4 on rgb,
depth and weights, 1e-3 on the integrated normals: the occupied-space
sampler's arcs and the scans of the importance sampling differ from JAX's
in the last bits, which can move a sample by an ulp and so its
permutohedral simplex at the finest levels (whose Jacobian jumps there).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volsurfs_tpu.models.fields import RGB as JRGB
from volsurfs_tpu.training import checkpoints as JCK
from volsurfs_tpu_torch.convert import module_state_from_flax
from volsurfs_tpu_torch.methods.surf import Surf
from volsurfs_tpu_torch.models.fields import RGB
from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
from volsurfs_tpu_torch.params.hyper_params import HyperParamsSuRF
from volsurfs_tpu_torch.training import checkpoints

from _torch_surf_pair import DATA_ITER, HP, RES, camera_rays, jax_grads, jax_grid, make_pair

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def test_sdf_and_colorsh_match_jax(pair):
    jmethod, params, method = pair
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.9, 0.9, (2048, 3)).astype(np.float32)
    dirs = rng.standard_normal((2048, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    it = DATA_ITER
    js, jg, jgrad = jmethod.sdf_model.apply(params["sdf"], jnp.asarray(pts), it, with_grads=True)
    ts, tg, tgrad = method.models["sdf"](torch.from_numpy(pts), it, with_grads=True)
    for got, ref in ((ts, js), (tg, jg), (tgrad, jgrad)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    normals = (tgrad / torch.linalg.norm(tgrad, dim=-1, keepdim=True)).detach()
    jrgb = jmethod.rgb_model.apply(params["rgb"], jnp.asarray(pts), jnp.asarray(dirs),
                                   jnp.asarray(normals.numpy()), jnp.asarray(tg.detach().numpy()),
                                   it)
    trgb = method.models["rgb"](torch.from_numpy(pts), torch.from_numpy(dirs), normals,
                                tg.detach(), it)
    np.testing.assert_allclose(trgb.detach().numpy(), np.asarray(jrgb), rtol=1e-5, atol=1e-5)


def test_render_rays_matches_jax(pair):
    jmethod, params, method = pair
    o, d = camera_rays(2)
    ref = jmethod.render_rays(params, jax_grid(jmethod, method.grid), jnp.asarray(o),
                              jnp.asarray(d), DATA_ITER, None, False)
    got = method.make_render_fn()(torch.from_numpy(o), torch.from_numpy(d))
    assert float(got["weights_sum"].max()) > 0.5  # the rays see a surface
    for name in ("rgb", "depth", "weights_sum"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    # a sample moved by an ulp into another simplex changes its normal
    # (measured: 2.9e-4 at one of the 64 rays)
    np.testing.assert_allclose(got["normals"].numpy(), np.asarray(ref["normals"]), rtol=1e-3,
                               atol=1e-3)


def test_rgb_field_matches_jax():
    """The RGB colour field (position encoding, SH of the view direction,
    normal, geometry feature) on converted parameters: 1e-5."""
    rng = np.random.default_rng(5)
    n = 1024
    pts = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    normals = rng.standard_normal((n, 3)).astype(np.float32)
    geom = rng.standard_normal((n, 8)).astype(np.float32)
    jmod = JRGB(mlp_layers_dims=(32, 32), in_geom_feat_size=8)
    args = [jnp.asarray(x) for x in (pts, dirs, normals, geom)]
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(0), *args))
    params["params"]["PermutoEncoder_0"]["table"] = rng.uniform(
        -0.5, 0.5, params["params"]["PermutoEncoder_0"]["table"].shape).astype(np.float32)
    tmod = RGB(mlp_layers_dims=(32, 32), in_geom_feat_size=8)
    tmod.load_state_dict(module_state_from_flax(params))
    ref = jmod.apply(params, *args)
    got = tmod(*(torch.from_numpy(x) for x in (pts, dirs, normals, geom)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_jax_checkpoint_carries_over(pair, tmp_path):
    """A JAX surf checkpoint (``sdf.msgpack``, ``rgb.msgpack``) loads into
    the port's modules through ``load_jax_params``, parameter for
    parameter; the port's iter_nr stays as it is."""
    jmethod, params, method = pair
    # JAX's save_checkpoint reads these fields of a TrainState
    state = SimpleNamespace(params=params, opt_state={}, key=np.zeros(2, np.uint32),
                            iter_nr=7, grid=None)
    JCK.save_checkpoint(str(tmp_path), state)
    fresh = Surf(HyperParamsSuRF(**HP), make_bounding_sphere(1.0), bg_color="white",
                 occupancy_res=RES, device="cpu", seed=3)
    assert checkpoints.load_jax_params(str(tmp_path), fresh) is fresh
    assert fresh.iter_nr == 0
    ref = jax_grads(params)  # the same flattening, of the parameters
    for name, module in fresh.models.items():
        for k, p in module.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), ref[f"{name}.{k}"])
