"""nerf with the trained background against volsurfs_tpu's, on the pair of
tests/_torch_nerf_pair.py (small widths, the full 24-level tables) with
NerfHash at its full width: the render (JAX takes the port's samples) and
one train step, its losses and every gradient, the background's included.
Both sides take the same random draws (the background's jitter one of
them); JAX runs op by op, with the exact table gradient (``flat``).

Tolerances: the render 1e-4 (tests/test_torch_nerf.py's); the step's losses
1e-5 relative and every gradient leaf within 3e-5 of its largest entry
(tests/test_torch_nerf_steps.py's, and why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_nerf_pair import DATA_ITER, HP, N_POINTS, R, make_pair
from _torch_surf_pair import (Draws, camera_rays, feed, jax_grads, jax_grid, jax_value_and_grad,
                              port_grads, share_samples)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    return make_pair(bg_color=None)


def test_render_rays_with_the_background_matches_jax(pair, monkeypatch):
    jmethod, params, method = pair
    o, d = camera_rays(2)
    share_samples(monkeypatch, method, jmethod)
    with torch.no_grad():
        got = method.render_rays(torch.from_numpy(o), torch.from_numpy(d), DATA_ITER)
    ref = jmethod.render_rays(params, jax_grid(jmethod, method.grid), jnp.asarray(o),
                              jnp.asarray(d), DATA_ITER, None, False)
    assert 0.0 < float(got["bg_transmittance"].mean()) < 1.0
    for name in ("rgb", "rgb_bg", "depth", "weights_sum", "bg_transmittance"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_train_step_with_the_background_matches_jax(pair, monkeypatch):
    jmethod, params, method = pair
    rng = np.random.default_rng(3)
    method.optimizer.zero_grad(set_to_none=True)
    o, d = camera_rays(4)
    gt = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    n_imp = HP["max_nr_imp_samples_per_ray"]
    n_bg = method.hp.nr_samples_bg
    u_bg = np.random.default_rng(13).uniform(0, 1, (R, n_bg)).astype(np.float32)
    draws = Draws(
        [((R, n_bg), u_bg),
         ((1024, 3), rng.standard_normal((N_POINTS, 3)).astype(np.float32)),
         ((1024, 1), rng.uniform(0, 1, (N_POINTS, 1)).astype(np.float32))],
        port_only=[rng.uniform(0, 1, (R, 1)).astype(np.float32),
                   rng.uniform(-0.5, 0.5, (R, n_imp)).astype(np.float32)])
    feed(monkeypatch, method, draws)
    share_samples(monkeypatch, method, jmethod)
    batch = {"rays_o": o, "rays_d": d, "gt_rgb": gt}
    loss, losses = method._loss({k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    grid = jax_grid(jmethod, method.grid)
    ref_losses, ref_grads = jax_value_and_grad(
        lambda p: jmethod._loss(p, grid, {k: jnp.asarray(v) for k, v in batch.items()}, 0,
                                jax.random.PRNGKey(0)), params)
    assert not draws.jax_queue and not draws.port_queue  # both took every draw
    loss.backward()
    for k in ref_losses:
        np.testing.assert_allclose(float(losses[k].detach()), float(ref_losses[k]), rtol=1e-5,
                                   atol=1e-9, err_msg=k)
    got, ref = port_grads(method), jax_grads(ref_grads, ("density", "rgb"))
    assert set(got) == set(ref) and any(k.startswith("bg.") for k in ref)
    for k, r in ref.items():
        scale = np.abs(r).max()
        assert scale > 0.0, k  # the rgb loss reaches every parameter
        err = np.abs(got[k] - r).max()
        assert err <= 3e-5 * scale, (k, err, scale)
    method.optimizer.zero_grad(set_to_none=True)
