"""Surf's data step with the trained background against volsurfs_tpu's, on
the pair of tests/_torch_surf_pair.py (small widths, the full 24-level
tables, NerfHash at its full width): the losses and every parameter's
gradient, the background's included. Both sides take the same random
draws (the background's jitter one of them) and JAX the port's samples, as
in tests/test_torch_surf_steps.py; JAX runs op by op, with the exact table
gradient (``flat``).

Tolerances: tests/test_torch_surf_steps.py's data step's
(``TOLERANCES["data"]``, and why), the background's parameters 1e-5
(float32 rounding: their gradients flow through the render alone).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_surf_pair import (DATA_ITER, HP, N_POINTS, R, Draws, camera_rays, compare, feed,
                              jax_grads, jax_grid, jax_value_and_grad, make_pair, share_samples)
from test_torch_surf_steps import TOLERANCES

torch.set_num_threads(2)

DATA_TOLERANCES = TOLERANCES["data"]


@pytest.fixture(scope="module")
def pair():
    return make_pair(bg_color=None)


def test_data_step_with_the_background_matches_jax(pair, monkeypatch):
    """One data step: the losses and every gradient, the background's
    included; the background's jitter a draw both take."""
    jmethod, params, method = pair
    rng = np.random.default_rng(3)
    method.optimizer.zero_grad(set_to_none=True)
    o, d = camera_rays(4)
    gt = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    n_imp = HP["max_nr_imp_samples_per_ray"] // 2
    S = HP["max_nr_samples_per_ray"] + HP["max_nr_imp_samples_per_ray"]
    n_bg = method.hp.nr_samples_bg
    # the background's jitter from a seed of its own, so that the other draws
    # are tests/test_torch_surf_steps.py's data step's
    u_bg = np.random.default_rng(13).uniform(0, 1, (R, n_bg)).astype(np.float32)
    draws = Draws(
        [((R, n_bg), u_bg),
         ((1024, 3), rng.standard_normal((N_POINTS, 3)).astype(np.float32)),
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
    assert not draws.jax_queue and not draws.port_queue  # both took every draw
    loss.backward()
    ref = jax_grads(ref_grads)
    assert any(k.startswith("bg.") for k in ref) and np.abs(ref["bg.encoder.table"]).max() > 0
    compare(losses, ref_losses, method, ref,
            {"losses": DATA_TOLERANCES["losses"],
             "grads": lambda k: 1e-5 if k.startswith("bg.") else DATA_TOLERANCES["grads"](k)})
    method.optimizer.zero_grad(set_to_none=True)
