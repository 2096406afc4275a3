"""Parity of the port's surf train steps with volsurfs_tpu's: one
sphere-init and one data step, losses and parameter gradients, on the
pair of tests/_torch_surf_pair.py (small widths, the full 24-level tables).
Both sides take the same random draws; in the data step JAX takes the
port's samples too (the samplers' parity is test_torch_samplers.py's and
test_torch_surf.py's render's), so that both evaluate the fields at the
same points. JAX runs op by op, with the exact table gradient (``flat``).
``TOLERANCES`` holds each case's tolerances and why.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_surf_pair import (DATA_ITER, HP, N_POINTS, R, compare, Draws, feed,
                              jax_grads, jax_grid, jax_value_and_grad, camera_rays,
                              share_samples, make_pair)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


# per case: the relative tolerances of the losses and of each gradient's L2
# error, with the errors measured on the CPU in brackets
TOLERANCES = {
    # the same points, float32 rounding [losses <= 1.1e-7, grads <= 4.1e-7]
    "sphere_init": {"losses": 1e-6, "grads": lambda k: 1e-5},
    # the same samples, the curvature term at base.cfg's weight [losses <=
    # 3.5e-7, rgb grads <= 4.4e-7]. The curvature term amplifies float32
    # rounding through arccos near 1: moving its shifted points by about
    # one ulp (eps 1e-4 -> 1.002e-4) changes the port's own SDF gradients by
    # 9.3e-5 (table) and <= 5.5e-6 (MLP); against JAX they differ by 1.05e-4
    # and <= 8.8e-6 [with curvature weight 1e-6: <= 8.8e-7]. Leaving out the
    # moved points' gradient (d_bary) costs 3.1e-3 and 2.3e-4.
    "data": {"losses": 1e-5,
             "grads": lambda k: 3e-4 if k == "sdf.encoder.table" else (
                 3e-5 if k.startswith("sdf") else 1e-5)},
}


@pytest.mark.parametrize("phase", list(TOLERANCES))
def test_train_step_losses_and_grads_match_jax(pair, monkeypatch, phase):
    jmethod, params, method = pair
    rng = np.random.default_rng(3)
    method.optimizer.zero_grad(set_to_none=True)
    if phase == "sphere_init":
        # N_POINTS of the 30,000 points the methods ask for
        draws = Draws([((30000, 3), rng.standard_normal((N_POINTS, 3)).astype(np.float32)),
                        ((30000, 1), rng.uniform(0, 1, (N_POINTS, 1)).astype(np.float32))])
        feed(monkeypatch, method, draws)
        loss, losses = method._sphere_init_loss(5)
        ref_losses, ref_grads = jax_value_and_grad(
            lambda p: jmethod._sphere_init_loss(p, 5, jax.random.PRNGKey(0)), params)
    else:
        o, d = camera_rays(4)
        gt = rng.uniform(0, 1, (R, 3)).astype(np.float32)
        n_imp = HP["max_nr_imp_samples_per_ray"] // 2
        S = HP["max_nr_samples_per_ray"] + HP["max_nr_imp_samples_per_ray"]
        # the samplers' jitter to the port alone; N_POINTS of the 1,024
        # random points the methods ask for
        draws = Draws(
            [((1024, 3), rng.standard_normal((N_POINTS, 3)).astype(np.float32)),
             ((1024, 1), rng.uniform(0, 1, (N_POINTS, 1)).astype(np.float32)),
             ((R, S, 3), rng.standard_normal((R, S, 3)).astype(np.float32))],
            port_only=[rng.uniform(0, 1, (R, 1)).astype(np.float32),
                       rng.uniform(-0.5, 0.5, (R, n_imp)).astype(np.float32),
                       rng.uniform(-0.5, 0.5, (R, n_imp)).astype(np.float32)])
        feed(monkeypatch, method, draws)
        share_samples(monkeypatch, method, jmethod)
        batch = {"rays_o": o, "rays_d": d, "gt_rgb": gt}
        loss, losses = method._data_loss({k: torch.from_numpy(v) for k, v in batch.items()},
                                         DATA_ITER)
        grid = jax_grid(jmethod, method.grid)
        ref_losses, ref_grads = jax_value_and_grad(
            lambda p: jmethod._data_loss(p, grid, {k: jnp.asarray(v) for k, v in batch.items()},
                                         DATA_ITER, jax.random.PRNGKey(0)), params)
        assert int(losses["nr_samples_total"]) == int(ref_losses["nr_samples_total"])
    assert not draws.jax_queue and not draws.port_queue  # both took every draw
    loss.backward()
    compare(losses, ref_losses, method, jax_grads(ref_grads), TOLERANCES[phase])
    method.optimizer.zero_grad(set_to_none=True)
