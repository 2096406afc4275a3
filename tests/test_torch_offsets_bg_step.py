"""One offsets_surfs color-init step with the trained background against
volsurfs_tpu's: the first phase that trains on the data (it renders, so the
background takes its gradient), its losses and every gradient, the
background's included, on the pair of tests/_torch_offsets_pair.py with
NerfHash at its full width (tests/_torch_offsets_steps.py, whose
``TOLERANCES`` hold the tolerances and why; the background's jitter is a
draw both take). JAX runs op by op.
"""

import pytest
import torch

from _torch_offsets_pair import make_pair
from _torch_offsets_steps import check_train_step

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    return make_pair(bg_color=None)


def test_color_init_step_with_the_background_matches_jax(pair, monkeypatch):
    assert "bg" in pair[2].models
    # every parameter's gradient, the background's among them, against JAX's
    check_train_step(pair, monkeypatch, "color_init")
