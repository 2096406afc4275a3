"""Parity of the port's offsets_surfs fields and render with volsurfs_tpu's:
OffsetsSDF (forward with and without grads, main_sdf_grad, get_offsets) on
converted parameters, get_offsets_gt, load_main_sdf from a port SDF, and
the volumetric render (OffsetsSurfs.render_rays, train=False) on the same
occupancy grid, for the pair of tests/_torch_offsets_pair.py (small widths,
the full 24-level permutohedral tables, K = 5 surfaces). JAX runs op by op.

Tolerances: the fields 1e-5 (float32 rounding; softplus, the tangents as
W t against JAX's (W t + b) - b). The render, on the port's samples on
both sides, 1e-4 as surf's (tests/test_torch_surf.py: the transmittance
scan runs in order here and as a tree in JAX, the shared fields' batched
MLP rounds otherwise); the integrated normals 1e-3, as surf's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volsurfs_tpu.methods.offsets_surfs import get_offsets_gt as j_offsets_gt
from volsurfs_tpu_torch.methods.offsets_surfs import OffsetsSurfs, get_offsets_gt
from volsurfs_tpu_torch.methods.surf import Surf
from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
from volsurfs_tpu_torch.params.hyper_params import HyperParamsOffsetsSuRFs, HyperParamsSuRF

from _torch_offsets_pair import DATA_ITER, HP, RES, make_pair
from _torch_surf_pair import camera_rays, jax_grid, share_samples

torch.set_num_threads(2)

FIELD_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _check(got, ref, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **(tol or FIELD_TOL))


def test_offsets_sdf_matches_jax(pair):
    jmethod, params, method = pair
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.9, 0.9, (2048, 3)).astype(np.float32)
    jpts, tpts = jnp.asarray(pts), torch.from_numpy(pts)
    model, jmodel, jp = method.models["sdfs"], jmethod.sdfs_model, params["sdfs"]
    it = DATA_ITER
    for got, ref in zip(model(tpts, it), jmodel.apply(jp, jpts, it)):
        _check(got, ref)
    got = model(tpts, it, with_grads=True)
    ref = jmodel.apply(jp, jpts, it, with_grads=True)
    assert got[3].shape == (2048, 5, 3)
    for g, r in zip(got, ref):
        _check(g, r)
    _check(model.main_sdf_grad(tpts, it), jmodel.apply(jp, jpts, it,
                                                        method=jmodel.main_sdf_grad))
    geom = model.main_sdf(tpts, it)[1]
    ref = jmodel.apply(jp, jnp.asarray(geom.detach().numpy()), method=jmodel.get_offsets)
    for g, r in zip(model.get_offsets(geom), ref):
        _check(g, r)
    # the inner offsets are positive and ordered largest first, the outer
    # negative
    cum_inner, cum_outer = model.get_offsets(geom)[:2]
    assert bool((cum_inner[:, :-1] > cum_inner[:, 1:]).all()) and bool((cum_outer < 0).all())


def test_offsets_gt_matches_jax(pair):
    jmethod, _, method = pair
    np.testing.assert_allclose(get_offsets_gt(2, 3, 0.1).numpy(),
                               np.asarray(j_offsets_gt(2, 3, 0.1)), atol=0)
    assert method.delta_surfs == jmethod.delta_surfs
    np.testing.assert_array_equal(method.offsets_gt.numpy(), np.asarray(jmethod.offsets_gt))


def test_load_main_sdf_from_a_port_surf():
    """A port Surf's SDF (encoder and MLP) goes into the shared encoder and
    the main head: the main surface's SDF and features equal the surf's."""
    surf_hp = HyperParamsSuRF(sdf_mlp_layers_dims=[16, 16], geom_feat_size=8,
                              sdf_nr_iters_for_c2f=0, use_occupancy_grid=False)
    surf = Surf(surf_hp, make_bounding_sphere(1.0), bg_color="white", device="cpu", seed=4)
    with torch.no_grad():
        surf.models["sdf"].encoder.table.uniform_(-0.1, 0.1)
    method = OffsetsSurfs(HyperParamsOffsetsSuRFs(**{**HP, "use_occupancy_grid": False}),
                          make_bounding_sphere(1.0), bg_color="white", occupancy_res=RES,
                          device="cpu")
    assert method.load_main_sdf(surf.models["sdf"].state_dict()) is method
    pts = torch.from_numpy(np.random.default_rng(2).uniform(-0.5, 0.5, (256, 3))
                           .astype(np.float32))
    sdf, geom = surf.models["sdf"](pts)
    sdfs, _, geom_o = method.models["sdfs"](pts)
    assert torch.equal(sdfs[:, method.main_surf_idx], sdf) and torch.equal(geom_o, geom)


def test_render_rays_matches_jax(pair, monkeypatch):
    """The render on shared samples (JAX takes the port's; the samplers'
    parity is tests/test_torch_samplers.py's, whose 2e-6 on z becomes up to
    6e-6 on these random fields' SDFs, and far more after the CDF's
    inversion where the weights are flat)."""
    jmethod, params, method = pair
    o, d = camera_rays(2)
    share_samples(monkeypatch, method, jmethod)
    with torch.no_grad():
        got = method.render_rays(torch.from_numpy(o), torch.from_numpy(d), DATA_ITER)
    ref = jmethod.render_rays(params, jax_grid(jmethod, method.grid), jnp.asarray(o),
                              jnp.asarray(d), DATA_ITER, None, False)
    np.testing.assert_array_equal(got["nr_samples"].numpy(), np.asarray(ref["nr_samples"]))
    assert float(got["bg_transmittance"].min()) < 0.5  # the rays see the surfaces
    assert got["surfs_alpha"].shape == (o.shape[0], 5, 1)
    for name in ("rgb", "bg_transmittance", "surfs_rgb", "surfs_alpha", "surfs_depths",
                 "surfs_weight_sum", "surfs_blending_weights"):
        _check(got[name], ref[name], rtol=1e-4, atol=1e-4, err_msg=name)
    _check(got["surfs_normals"], ref["surfs_normals"], rtol=1e-3, atol=1e-3)
    # the render function's outputs, as JAX's make_render_fn gives them
    out = method.make_render_fn()(torch.from_numpy(o), torch.from_numpy(d))
    assert set(out) == {"rgb", "bg_transmittance", "surfs_alpha"}
    assert torch.equal(out["rgb"], got["rgb"])
    assert torch.equal(out["surfs_alpha"], got["surfs_alpha"][..., 0])

