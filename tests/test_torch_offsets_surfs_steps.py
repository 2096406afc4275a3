"""Parity of the port's offsets_surfs train steps with volsurfs_tpu's in the
init phases, offsets-init and color-init (tests/_torch_offsets_steps.py),
and Adam's steps of the parameters a phase freezes."""

import pytest
import torch

from _torch_offsets_pair import R, make_pair, PHASE_ITERS
from _torch_offsets_steps import check_train_step
from _torch_surf_pair import camera_rays

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


@pytest.mark.parametrize("phase", ["offsets_init", "color_init"])
def test_train_step_losses_and_grads_match_jax(pair, monkeypatch, phase):
    check_train_step(pair, monkeypatch, phase)


def test_frozen_parameters_take_adam_steps_as_optax(pair):
    """A phase that freezes a module still moves it by its Adam moments,
    as optax does: after a first-phase step (moments everywhere), a
    color-init step leaves no parameter where it was."""
    _, _, method = pair
    saved = {k: v.clone() for k, v in method.models.state_dict().items()}
    opt_state = method.optimizer.state_dict()
    sched_state = method.scheduler.state_dict()
    it0 = method.iter_nr
    for p in method.models.parameters():
        p.grad = torch.ones_like(p)  # moments from a step that reached everything
    method.optimizer.step()
    method.iter_nr = PHASE_ITERS["color_init"]
    before = {k: v.clone() for k, v in method.models.state_dict().items()}
    o, d = camera_rays(5, R)
    batch = {"rays_o": torch.from_numpy(o), "rays_d": torch.from_numpy(d),
             "gt_rgb": torch.full((R, 3), 0.5)}
    losses = method.train_step(batch)
    assert float(losses["grad_norm/sdfs"]) == 0.0  # frozen in color-init
    moved = {k: not torch.equal(v, method.models.state_dict()[k]) for k, v in before.items()}
    assert all(moved.values()), [k for k, m in moved.items() if not m]
    method.models.load_state_dict(saved)
    method.optimizer.load_state_dict(opt_state)
    method.scheduler.load_state_dict(sched_state)
    method.iter_nr = it0
