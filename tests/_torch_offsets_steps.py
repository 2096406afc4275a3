"""The check of one train step of an offsets_surfs phase against
volsurfs_tpu's (imports JAX), shared by tests/test_torch_offsets_surfs_steps.py
(the init phases) and tests/test_torch_offsets_surfs_data_steps.py (the data
phases): its losses and every parameter's gradient, on the pair of
tests/_torch_offsets_pair.py (small widths, the full 24-level tables, K = 5
surfaces). Both sides take the same random draws; in the data phases JAX
takes the port's samples too (the samplers' parity is
tests/test_torch_samplers.py's), so that both evaluate the fields at the
same points. JAX runs op by op, with the exact table gradient (``flat``);
each of its data steps takes ~90 s on the CPU, most of it compiling its ops
anew. ``TOLERANCES`` holds each phase's tolerances and why.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_offsets_pair import HP, N_POINTS, PHASE_ITERS, R, S, flat_grads, port_grads
from _torch_surf_pair import Draws, camera_rays, feed, jax_grid, jax_value_and_grad, share_samples

# per phase: the relative tolerances of the losses and of each gradient's
# L2 error, as tests/test_torch_surf_steps.py's
_DATA = {"losses": 1e-5, "grads": lambda k: 1e-5}
TOLERANCES = {
    # the offsets fit and the support surfaces' eikonal term on the same
    # points: float32 rounding
    "offsets_init": {"losses": 1e-6, "grads": lambda k: 1e-5},
    # the render's and the regularisers' gradients into the colour fields
    # and (through the offsets' eikonal and off-surface terms) nothing else
    "color_init": _DATA,
    # the curvature term at base_5.cfg's weight, as surf's data step: it
    # amplifies float32 rounding through arccos near 1 (see
    # tests/test_torch_surf_steps.py), so the SDF's table 3e-4 and its MLPs
    # 3e-5; everything else 1e-5
    "first": {"losses": 1e-5,
              "grads": lambda k: 3e-4 if k == "sdfs.pos_encoder.table" else (
                  3e-5 if k.startswith("sdfs") else 1e-5)},
}
TOLERANCES["second"] = TOLERANCES["first"]


def _data_draws(rng, train_main, nr_samples_bg=0):
    """The data step's draws: the samplers' jitter to the port alone, then
    the trained background's jitter (where nr_samples_bg > 0, from a seed of
    its own, so that the other draws stay the same), N_POINTS of the 1,024
    random points and, where the main surface trains, the curvature
    directions."""
    n_imp = HP["max_nr_imp_samples_per_ray"] // 2
    requests = [((1024, 3), rng.standard_normal((N_POINTS, 3)).astype(np.float32)),
                ((1024, 1), rng.uniform(0, 1, (N_POINTS, 1)).astype(np.float32))]
    if nr_samples_bg:
        requests.insert(0, ((R, nr_samples_bg), np.random.default_rng(13).uniform(
            0, 1, (R, nr_samples_bg)).astype(np.float32)))
    if train_main:
        requests.append(((R, S, 3), rng.standard_normal((R, S, 3)).astype(np.float32)))
    return Draws(requests, port_only=[rng.uniform(0, 1, (R, 1)).astype(np.float32),
                                      rng.uniform(-0.5, 0.5, (R, n_imp)).astype(np.float32),
                                      rng.uniform(-0.5, 0.5, (R, n_imp)).astype(np.float32)])


def check_train_step(pair, monkeypatch, phase):
    """One step of phase on both sides: the same losses, and every
    parameter's gradient within TOLERANCES[phase] (zero on both sides where
    the phase freezes it)."""
    jmethod, params, method = pair
    it = PHASE_ITERS[phase]
    assert method.phase(it) == jmethod._phase(it) == phase
    rng = np.random.default_rng(7)
    method.optimizer.zero_grad(set_to_none=True)
    train_main = phase in ("first", "second")
    if phase == "offsets_init":
        # N_POINTS of the 30,000 points the methods ask for
        draws = Draws([((30000, 3), rng.standard_normal((N_POINTS, 3)).astype(np.float32)),
                       ((30000, 1), rng.uniform(0, 1, (N_POINTS, 1)).astype(np.float32))])
        feed(monkeypatch, method, draws)
        loss, losses = method._loss(None, it)
        ref_losses, ref_grads = jax_value_and_grad(
            lambda p: jmethod._offsets_init_loss(p, it, jax.random.PRNGKey(0)), params)
    else:
        o, d = camera_rays(4, R)
        gt = rng.uniform(0, 1, (R, 3)).astype(np.float32)
        draws = _data_draws(rng, train_main,
                            method.hp.nr_samples_bg if "bg" in method.models else 0)
        feed(monkeypatch, method, draws)
        share_samples(monkeypatch, method, jmethod)
        batch = {"rays_o": o, "rays_d": d, "gt_rgb": gt}
        loss, losses = method._loss({k: torch.from_numpy(v) for k, v in batch.items()}, it)
        grid = jax_grid(jmethod, method.grid)
        ref_losses, ref_grads = jax_value_and_grad(
            lambda p: jmethod._data_loss(p, grid, {k: jnp.asarray(v) for k, v in batch.items()},
                                         it, jax.random.PRNGKey(0), train_main,
                                         phase != "color_init"), params)
        assert int(losses["nr_samples_total"]) == int(ref_losses["nr_samples_total"])
    assert not draws.jax_queue and not draws.port_queue  # both took every draw
    assert set(losses) == set(ref_losses)
    loss.backward()
    tol = TOLERANCES[phase]
    for k in ref_losses:
        np.testing.assert_allclose(float(losses[k].detach()), float(ref_losses[k]), rtol=tol["losses"],
                                   atol=1e-9, err_msg=k)
    got, ref = port_grads(method), flat_grads(ref_grads)
    assert set(got) == set(ref)
    for k, r in ref.items():
        if not np.any(r):  # frozen, or out of the loss's reach, on both sides
            assert not np.any(got[k]), k
            continue
        err = np.linalg.norm(got[k] - r) / np.linalg.norm(r)
        assert err <= tol["grads"](k), (k, err, tol["grads"](k))
    method.optimizer.zero_grad(set_to_none=True)
