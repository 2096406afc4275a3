"""The volsurfs render with the trained background against volsurfs_tpu's,
on the pair of tests/test_torch_volsurfs.py (the tiny flagship model) with
NerfHash at its full width (32 samples a ray,
tests/_torch_volsurfs_bg_pair.py); the train step:
tests/test_torch_volsurfs_bg_step.py. The background's rgb enters the
float16 composite as JAX's does.

Tolerances: tests/test_torch_volsurfs.py's float16 rule: the render 2e-3
(a float16 rounding step is 4.9e-4; the port rounds every float16 op as
written, XLA keeps some intermediates wider); the background's rgb, float32,
1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_volsurfs_bg_pair import make_bg_pair

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    return make_bg_pair()


def test_render_rays_with_the_background_matches_jax(pair):
    jmethod, jstate, tmethod, batch = pair
    ref = jmethod.render_rays(jstate.params, None, jnp.asarray(batch["rays_o"]),
                              jnp.asarray(batch["rays_d"]), 0, None, False)
    with torch.no_grad():
        out = tmethod.render_rays(torch.from_numpy(batch["rays_o"]),
                                  torch.from_numpy(batch["rays_d"]))
    hit = np.asarray(ref["surfs_hits"]).any(-1)
    assert 0.2 < hit.mean() < 0.9  # shells and background both
    np.testing.assert_allclose(out["rgb_bg"].numpy(), np.asarray(ref["rgb_bg"]), rtol=1e-5,
                               atol=1e-6)
    for name in ("rgb", "bg_transmittance"):
        np.testing.assert_allclose(out[name].numpy(), np.asarray(ref[name]), atol=2e-3, rtol=0,
                                   err_msg=name)
