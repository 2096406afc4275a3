"""offsets_surfs' render with the trained background against
volsurfs_tpu's, on the pair of tests/_torch_offsets_pair.py (small widths,
the full 24-level tables, K = 5 surfaces) with NerfHash at its full width;
JAX takes the port's samples and runs op by op. The train step with the
background: tests/test_torch_offsets_bg_step.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_offsets_pair import DATA_ITER, make_pair
from _torch_surf_pair import camera_rays, jax_grid, share_samples

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    return make_pair(bg_color=None)


def test_render_rays_with_the_background_matches_jax(pair, monkeypatch):
    """rgb, the background's rgb and the transmittance to it, within the
    render's 1e-4 of tests/test_torch_offsets_surfs.py."""
    jmethod, params, method = pair
    o, d = camera_rays(2)
    share_samples(monkeypatch, method, jmethod)
    with torch.no_grad():
        got = method.render_rays(torch.from_numpy(o), torch.from_numpy(d), DATA_ITER)
    ref = jmethod.render_rays(params, jax_grid(jmethod, method.grid), jnp.asarray(o),
                              jnp.asarray(d), DATA_ITER, None, False)
    assert 0.0 < float(got["bg_transmittance"].mean()) < 1.0
    for name in ("rgb", "rgb_bg", "bg_transmittance"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
