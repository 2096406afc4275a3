"""Parity of the port's offsets_surfs train steps with volsurfs_tpu's in the
data phases, first and second, with the curvature term
(tests/_torch_offsets_steps.py)."""

import pytest
import torch

from _torch_offsets_pair import make_pair
from _torch_offsets_steps import check_train_step

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


@pytest.mark.parametrize("phase", ["first", "second"])
def test_train_step_losses_and_grads_match_jax(pair, monkeypatch, phase):
    check_train_step(pair, monkeypatch, phase)
