"""The volsurfs train step with the trained background against
volsurfs_tpu's, on the pair of tests/test_torch_volsurfs.py (the tiny
flagship model) with NerfHash at its full width (32 samples a ray,
tests/_torch_volsurfs_bg_pair.py): the loss and every gradient, the
background's included (its jitter a draw both take). The background's rgb
enters the float16 composite as JAX's does.

Tolerances: tests/test_torch_volsurfs.py's float16 rule: the render 2e-3
(a float16 rounding step is 4.9e-4; the port rounds every float16 op as
written, XLA keeps some intermediates wider); the loss 1e-5; each gradient
rtol 1e-4 with an atol of 1e-6 of the tensor's largest entry (float32
summation noise where sums cancel to ~0), but the alpha textures', whose
atol is 2^-9 (four float16 steps) of their largest entry. Their gradients
are sums of float16 cotangents, taken in another order by each package's
autograd; with the white background the composite's background term is
exactly the transmittance, with a trained one a float16 product that
rounds, and the sums then differ by up to 1.2e-3 of a tensor's largest
entry (measured; 1.7e-11 absolute with the white one). The rgb textures'
gradients hold at 1e-6; the background's at 1e-5 of each tensor's L2 norm,
the other methods' background rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volsurfs_tpu.models import encodings as JE
from volsurfs_tpu_torch.convert import params_from_jax

from _torch_volsurfs_bg_pair import N_RAYS, make_bg_pair

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    return make_bg_pair()


def test_loss_and_gradients_with_the_background_match_jax(pair, monkeypatch):
    jmethod, jstate, tmethod, batch = pair
    n_bg = tmethod.hp.nr_samples_bg
    u = np.random.default_rng(8).uniform(0, 1, (N_RAYS, n_bg)).astype(np.float32)
    real = jax.random.uniform
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: (
        jnp.asarray(u) if tuple(shape) == u.shape else real(key, shape, *a, **k)))
    monkeypatch.setattr(tmethod, "_uniform", lambda shape: torch.from_numpy(u))

    def loss_fn(params):
        return jmethod._loss(params, {k: jnp.asarray(v) for k, v in batch.items()},
                             jstate.iter_nr, jstate.key, jmethod.scene)[0]

    prev = JE._TABLE_GRAD_MODE
    JE.set_table_grad_mode("flat")
    try:
        ref_loss, ref_grads = jax.value_and_grad(loss_fn)(jstate.params)
    finally:
        JE.set_table_grad_mode(prev)
    tmethod.optimizer.zero_grad(set_to_none=True)
    loss = tmethod._loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=1e-5, rtol=0)
    ref_all = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_grads))
    assert "bg" in ref_all
    for name, ref_state in ref_all.items():
        params = dict(tmethod.models[name].named_parameters())
        for key, ref_g in ref_state.items():
            g = params[key].grad
            g = np.zeros_like(ref_g.numpy()) if g is None else g.numpy()
            scale = float(np.abs(ref_g.numpy()).max())
            if name == "bg":
                # the background's rule of the other methods' tests: 1e-5 of
                # the tensor's L2 norm (its density bias sums cancelling
                # terms, where float32 noise is 3e-6 of the largest entry)
                assert scale > 0.0, key  # the loss reaches the background
                err = np.linalg.norm(g - ref_g.numpy()) / np.linalg.norm(ref_g.numpy())
                assert err <= 1e-5, (key, err)
                continue
            # the alphas' gradients: four float16 steps (2^-9) of the
            # tensor's largest entry
            atol = (2.0 ** -9 if name.startswith("alpha") else 1e-6) * scale
            np.testing.assert_allclose(g, ref_g.numpy(), rtol=1e-4, atol=atol,
                                       err_msg=f"{name}.{key}")
    tmethod.optimizer.zero_grad(set_to_none=True)
