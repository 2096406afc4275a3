"""Parity of the port's nerf train step with volsurfs_tpu's: its losses and
every parameter's gradient, at iter_nr 0 and 5,001, on either side of the
sparsity term's gate (JAX's hard-coded iter_nr > 5000), on the pair of
tests/_torch_nerf_pair.py (small widths, the full 24-level tables). Both
sides take the same random draws; JAX takes the port's samples too (the
samplers' parity is tests/test_torch_nerf.py's render's), so that both
evaluate the fields at the same points. JAX runs op by op, with the exact
table gradient (``flat``).

Tolerances: the losses 1e-5 relative; every gradient leaf within 3e-5 of
its largest entry (max |port - JAX| <= 3e-5 max |JAX|), the data steps'
tolerance of tests/test_torch_offsets_surfs_data_steps.py: float32
rounding of the same sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_nerf_pair import HP, N_POINTS, R, make_pair
from _torch_surf_pair import (Draws, camera_rays, feed, jax_grads, jax_grid, jax_value_and_grad,
                              port_grads, share_samples)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


@pytest.mark.parametrize("iter_nr", [0, 5001])
def test_train_step_losses_and_grads_match_jax(pair, monkeypatch, iter_nr):
    jmethod, params, method = pair
    rng = np.random.default_rng(3)
    method.optimizer.zero_grad(set_to_none=True)
    o, d = camera_rays(4)
    gt = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    n_imp = HP["max_nr_imp_samples_per_ray"]
    # the samplers' jitter to the port alone; N_POINTS of the 1,024 random
    # points of the sparsity term, which both draw at every step
    draws = Draws(
        [((1024, 3), rng.standard_normal((N_POINTS, 3)).astype(np.float32)),
         ((1024, 1), rng.uniform(0, 1, (N_POINTS, 1)).astype(np.float32))],
        port_only=[rng.uniform(0, 1, (R, 1)).astype(np.float32),
                   rng.uniform(-0.5, 0.5, (R, n_imp)).astype(np.float32)])
    feed(monkeypatch, method, draws)
    share_samples(monkeypatch, method, jmethod)
    batch = {"rays_o": o, "rays_d": d, "gt_rgb": gt}
    loss, losses = method._loss({k: torch.from_numpy(v) for k, v in batch.items()}, iter_nr)
    grid = jax_grid(jmethod, method.grid)
    ref_losses, ref_grads = jax_value_and_grad(
        lambda p: jmethod._loss(p, grid, {k: jnp.asarray(v) for k, v in batch.items()}, iter_nr,
                                jax.random.PRNGKey(0)), params)
    assert not draws.jax_queue and not draws.port_queue  # both took every draw
    assert set(losses) == set(ref_losses)
    assert int(losses["nr_samples_total"]) == int(ref_losses["nr_samples_total"])
    assert (float(losses["sparsity"]) > 0.0) == (iter_nr > 5000)
    loss.backward()
    for k in ref_losses:
        np.testing.assert_allclose(float(losses[k].detach()), float(ref_losses[k]), rtol=1e-5,
                                   atol=1e-9, err_msg=k)
    got, ref = port_grads(method), jax_grads(ref_grads, ("density", "rgb"))
    assert set(got) == set(ref)
    for k, r in ref.items():
        scale = np.abs(r).max()
        assert scale > 0.0, k  # the rgb loss reaches every parameter
        err = np.abs(got[k] - r).max()
        assert err <= 3e-5 * scale, (k, err, scale)
    method.optimizer.zero_grad(set_to_none=True)
