"""Parity of the port's nerf method with volsurfs_tpu's, piece by piece: the
Density field, ``nerf_weights`` and its gradient, the importance round's
plain version (``nerf_importance_reference``: the CDF, then the depths with
and without jitter), the occupancy refresh, the volumetric render and a JAX
checkpoint loaded into the port, for the pair of tests/_torch_nerf_pair.py
(small widths, the full 24-level permutohedral tables). JAX runs op by op.

Tolerances: the field 1e-5 (float32 rounding in the MLP's sums); the
weights 1e-6 (the scan runs in order here and as a tree in JAX) and their
gradient 1e-5 relative; the CDF 2e-6; the importance depths 1e-4 with the
masks equal (a target on a flat stretch of the CDF moves along it with the
CDF's last bits); the render 1e-4, as the surf render's.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volsurfs_tpu.models.fields import Density as JDensity
from volsurfs_tpu.ops import occupancy as JO
from volsurfs_tpu.ops import samples as JS
from volsurfs_tpu.ops import volume_rendering as JVR
from volsurfs_tpu.training import checkpoints as JCK
from volsurfs_tpu_torch.convert import module_state_from_flax
from volsurfs_tpu_torch.methods.nerf import NeRF
from volsurfs_tpu_torch.models.fields import Density
from volsurfs_tpu_torch.ops import occupancy as TO
from volsurfs_tpu_torch.ops import samples as TS
from volsurfs_tpu_torch.ops import volume_rendering as TVR
from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
from volsurfs_tpu_torch.params.hyper_params import HyperParamsNeRF, get_method_hyper_params
from volsurfs_tpu_torch.training import checkpoints

from _torch_nerf_pair import DATA_ITER, HP, RES, make_pair
from _torch_surf_pair import camera_rays, jax_grads, jax_grid

torch.set_num_threads(2)

NERF_CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "config", "nerf",
                        "base.cfg")


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _samples(seed, n=256, s=40):
    """The same samples in both packages: sorted depths in [t0, t1] with a
    valid prefix a ray (empty, one-sample and full rows among them), dt by
    update_dt, and densities from 0 to past 100 (opaque runs)."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.float32([[0.0, 0.0, -2.0]]), (n, 1))
    d = np.tile(np.float32([[0.0, 0.0, 1.0]]), (n, 1))
    t0, t1 = np.full((n, 1), 1.0, np.float32), np.full((n, 1), 3.0, np.float32)
    count = rng.integers(0, s + 1, (n, 1))
    count[:6] = [[0], [1], [2], [s], [s], [s]]
    mask = np.arange(s)[None, :] < count
    z = np.sort(rng.uniform(1.0, 3.0, (n, s)), axis=1)
    z = np.where(mask, z, JS.INVALID_Z).astype(np.float32)
    max_dt = np.full((n, 1), 2.0 / s, np.float32)
    jsamp = JS.update_dt(JS.RaySamples(
        z=jnp.asarray(z), dt=jnp.zeros(z.shape), mask=jnp.asarray(mask), rays_o=jnp.asarray(o),
        rays_d=jnp.asarray(d), t_near=jnp.asarray(t0), t_far=jnp.asarray(t1),
        max_dt=jnp.asarray(max_dt)))
    tsamp = TS.update_dt(TS.RaySamples(
        z=torch.from_numpy(z), dt=torch.zeros(z.shape), mask=torch.from_numpy(mask),
        rays_o=torch.from_numpy(o), rays_d=torch.from_numpy(d), t_near=torch.from_numpy(t0),
        t_far=torch.from_numpy(t1), max_dt=torch.from_numpy(max_dt)))
    density = rng.uniform(0.0, 3.0, (n, s, 1)).astype(np.float32)
    density[rng.uniform(0, 1, (n, s)) < 0.1] = 0.0
    density[::5, 4:9] = 150.0  # opaque runs: alpha 1, the scan's factors 1e-6
    return jsamp, tsamp, density, rng


def test_density_matches_jax():
    """The Density field (24-level permutohedral encoder with its
    coarse-to-fine window half open, MLP, softplus) on converted
    parameters: density and geometry features within 1e-5."""
    rng = np.random.default_rng(1)
    pts = jnp.asarray(rng.uniform(-0.9, 0.9, (2048, 3)).astype(np.float32))
    jmod = JDensity(mlp_layers_dims=(16, 16), geom_feat_size=8, nr_iters_for_c2f=50)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(0), pts[:8]))
    params["params"]["PermutoEncoder_0"]["table"] = rng.uniform(
        -0.05, 0.05, params["params"]["PermutoEncoder_0"]["table"].shape).astype(np.float32)
    tmod = Density(mlp_layers_dims=(16, 16), geom_feat_size=8, nr_iters_for_c2f=50)
    tmod.load_state_dict(module_state_from_flax(params))
    jd, jg = jmod.apply(params, pts, 30)
    td, tg = tmod(torch.from_numpy(np.asarray(pts)), 30)
    assert float(td.min()) > 0.0
    for got, ref in ((td, jd), (tg, jg)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_nerf_weights_and_gradient_match_jax():
    """nerf_weights (the alphas, K8b's plain scan): weights and
    bg_transmittance within 1e-6; the densities' gradient, with cotangents
    on both outputs, against jax.grad within 1e-5 relative of its
    largest entry."""
    jsamp, tsamp, density, rng = _samples(2)
    g_w = rng.standard_normal(density.shape[:2]).astype(np.float32)
    g_bg = rng.standard_normal((density.shape[0], 1)).astype(np.float32)

    def jax_loss(sigma):
        w, bg = JVR.nerf_weights(jsamp, sigma)
        return jnp.sum(w * g_w) + jnp.sum(bg * g_bg)

    ref_w, ref_bg = JVR.nerf_weights(jsamp, jnp.asarray(density))
    ref_grad = np.asarray(jax.grad(jax_loss)(jnp.asarray(density)))
    sigma = torch.from_numpy(density).requires_grad_(True)
    w, bg = TVR.nerf_weights(tsamp, sigma)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(ref_w), rtol=0, atol=1e-6)
    np.testing.assert_allclose(bg.detach().numpy(), np.asarray(ref_bg), rtol=0, atol=1e-6)
    (torch.sum(w * torch.from_numpy(g_w)) + torch.sum(bg * torch.from_numpy(g_bg))).backward()
    scale = np.abs(ref_grad).max()
    assert scale > 0.1 and (bg.detach().numpy() < 1e-6).any()
    np.testing.assert_allclose(sigma.grad.numpy(), ref_grad, rtol=0, atol=1e-5 * scale)


def _jax_cdf(jsamp, density):
    """JAX nerf's chain before importance_sample (methods/nerf.py:143-148)."""
    weights, _ = JVR.nerf_weights(jsamp, density)
    _, w_sum = JVR.sum_over_rays(weights, jsamp.mask)
    return JVR.compute_cdf(weights / jnp.clip(w_sum, 1e-6), jsamp.mask)


@pytest.mark.parametrize("case", ["cdf", "no_jitter", "jitter"])
def test_nerf_importance_reference_matches_jax(case):
    """nerf_importance_reference, the plain version K8d is held to: its
    CDF (``nerf_cdf``) within 2e-6 of JAX's chain, and its 16 depths
    within 1e-4 of ``importance_sample`` of that CDF, masks equal, without
    jitter and with the jitter JAX's own draw gives (uniform in
    [-0.5, 0.5) from a key), handed to the port."""
    jsamp, tsamp, density, _ = _samples(3)
    ref_cdf = _jax_cdf(jsamp, jnp.asarray(density))
    if case == "cdf":
        cdf = TVR.nerf_cdf(tsamp, torch.from_numpy(density))
        np.testing.assert_allclose(cdf.numpy(), np.asarray(ref_cdf), rtol=0, atol=2e-6)
        return
    n = 16
    key = jax.random.PRNGKey(7) if case == "jitter" else None
    ref = JVR.importance_sample(jsamp, ref_cdf, n, key)
    jitter = None
    if key is not None:
        jitter = torch.from_numpy(np.asarray(jax.random.uniform(
            key, (density.shape[0], n), minval=-0.5, maxval=0.5)))
    got = TVR.nerf_importance(tsamp, torch.from_numpy(density), n, jitter)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    assert got.mask.any() and not got.mask.all()
    np.testing.assert_allclose(got.z.numpy(), np.asarray(ref.z), rtol=0, atol=1e-4)


def test_occupancy_refresh_matches_jax(pair, monkeypatch):
    """update_occupancy_grid on the same jittered voxel centres (numpy
    draws in [-0.5, 0.5) voxels, handed to both) and the same old values:
    the new values (JAX's max(density, 0.8 old)) within 1e-5 relative, the
    occupancy (density > 1e-4) equal. The density's last bias is moved so
    that the threshold splits the voxels."""
    jmethod, params, method = pair
    rng = np.random.default_rng(4)
    n = RES ** 3
    centers = method.grid.voxel_centers().numpy()
    pts = (centers + rng.uniform(-0.5, 0.5, centers.shape) * 2.0 / RES).astype(np.float32)
    old = rng.uniform(0.0, 2e-4, (RES,) * 3).astype(np.float32)
    last = f"dense_{len(HP['density_mlp_layers_dims'])}"
    params = jax.tree_util.tree_map(np.copy, params)
    params["density"]["params"]["MLP_0"][last]["bias"][0] -= 9.5
    port = NeRF(HyperParamsNeRF(**HP), make_bounding_sphere(1.0), bg_color="white",
                occupancy_res=RES, device="cpu")
    port.models["density"].load_state_dict(module_state_from_flax(params["density"]))
    port.iter_nr = DATA_ITER
    port.grid = TO.OccupancyGrid(torch.from_numpy(old), port.grid.occupancy, port.grid.roi,
                                 port.grid.extent)
    monkeypatch.setattr(TO.OccupancyGrid, "get_grid_samples",
                        lambda self, start, stop, gen: torch.from_numpy(pts[start:stop]))
    monkeypatch.setattr(JO.OccupancyGrid, "get_grid_samples", lambda self, key: jnp.asarray(pts))
    port.update_occupancy_grid()
    jgrid = jax_grid(jmethod, port.grid).replace(values=jnp.asarray(old))
    state = SimpleNamespace(grid=jgrid, key=jax.random.PRNGKey(0), params=params,
                            iter_nr=DATA_ITER, replace=lambda **kw: SimpleNamespace(**kw))
    with jax.disable_jit():
        ref = jmethod.update_occupancy_grid(state).grid
    occupied = port.grid.occupancy.numpy()
    assert 0.1 < occupied.mean() < 0.9 and port.grid.values.numel() == n
    np.testing.assert_allclose(port.grid.values.numpy(), np.asarray(ref.values), rtol=1e-5,
                               atol=0)
    np.testing.assert_array_equal(occupied, np.asarray(ref.occupancy))


def test_render_rays_matches_jax(pair):
    """The volumetric render (train=False) on the same occupancy grid, each
    package sampling on its own (K7's and K8d's plain versions against
    JAX's sampler and importance round): rgb, depth and weights_sum within
    1e-4."""
    jmethod, params, method = pair
    o, d = camera_rays(2)
    ref = jmethod.render_rays(params, jax_grid(jmethod, method.grid), jnp.asarray(o),
                              jnp.asarray(d), DATA_ITER, None, False)
    got = method.make_render_fn()(torch.from_numpy(o), torch.from_numpy(d))
    assert float(got["weights_sum"].max()) > 0.5  # the rays see matter
    for name in ("rgb", "depth", "weights_sum"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_jax_checkpoint_and_config_carry_over(pair, tmp_path):
    """A JAX nerf checkpoint (``density.msgpack``, ``rgb.msgpack``) loads
    into the port's modules through ``load_jax_params``, parameter for
    parameter; and config/nerf/base.cfg reads into HyperParamsNeRF."""
    jmethod, params, method = pair
    state = SimpleNamespace(params=params, opt_state={}, key=np.zeros(2, np.uint32),
                            iter_nr=7, grid=None)
    JCK.save_checkpoint(str(tmp_path), state)
    fresh = NeRF(HyperParamsNeRF(**HP), make_bounding_sphere(1.0), bg_color="white",
                 occupancy_res=RES, device="cpu", seed=3)
    assert checkpoints.load_jax_params(str(tmp_path), fresh) is fresh
    ref = jax_grads(params, ("density", "rgb"))  # the same flattening, of the parameters
    for name, module in fresh.models.items():
        for k, p in module.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), ref[f"{name}.{k}"])
    hp = get_method_hyper_params("nerf", NERF_CFG)
    assert (hp.density_mlp_layers_dims, hp.geom_feat_size, hp.rgb_mlp_layers_dims) == (
        [32, 32, 32], 32, [128, 128, 64])
    assert (hp.max_nr_samples_per_ray, hp.max_nr_imp_samples_per_ray, hp.sparsity_weight) == (
        64, 32, 1e-4)
