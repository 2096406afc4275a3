"""Parity of the torch port's VolSurfs with volsurfs_tpu's on the tiny
flagship model of __graft_entry__.py (3 shells, sh_degree 1, 64 rays),
with the JAX parameters carried over by volsurfs_tpu_torch.convert."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_volsurfs
from volsurfs_tpu.models import encodings as JE
from volsurfs_tpu_torch.convert import volsurfs_params_from_jax
from volsurfs_tpu_torch.methods.volsurfs import VolSurfs
from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
from volsurfs_tpu_torch.params.hyper_params import HyperParamsVolSurfs

torch.set_num_threads(2)

N_RAYS = 64


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def flat_table_grads():
    """Exact f32 table gradients on the JAX side (its default rounds them to
    bf16)."""
    prev = JE._TABLE_GRAD_MODE
    JE.set_table_grad_mode("flat")
    try:
        yield
    finally:
        JE.set_table_grad_mode(prev)


@pytest.fixture(scope="module")
def pair(flat_table_grads):
    """(JAX method, JAX state, torch method with the same parameters, batch)."""
    jmethod, jstate = _tiny_volsurfs(jax.random.PRNGKey(0))
    tmethod = _torch_method(jmethod, jstate)

    rng = np.random.default_rng(7)
    o = rng.standard_normal((N_RAYS, 3))
    o = 2.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-0.4, 0.4, (N_RAYS, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    batch = {
        "rays_o": o.astype(np.float32),
        "rays_d": d.astype(np.float32),
        "gt_rgb": rng.uniform(0.0, 1.0, (N_RAYS, 3)).astype(np.float32),
        "gt_mask": np.ones((N_RAYS, 1), np.float32),
    }
    return jmethod, jstate, tmethod, batch


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_render_rays_matches_jax(pair):
    jmethod, jstate, tmethod, batch = pair
    ref = jmethod.render_rays(
        jstate.params, None, jnp.asarray(batch["rays_o"]), jnp.asarray(batch["rays_d"]),
        0, None, False,
    )
    out = tmethod.make_render_fn()(
        torch.from_numpy(batch["rays_o"]), torch.from_numpy(batch["rays_d"])
    )
    hit = np.asarray(ref["surfs_hits"]).any(-1)
    assert 0.3 < hit.mean() < 1.0
    np.testing.assert_allclose(out["rgb"].numpy(), np.asarray(ref["rgb"]), atol=2e-3, rtol=0)
    np.testing.assert_allclose(
        out["bg_transmittance"].numpy(), np.asarray(ref["bg_transmittance"]), atol=2e-3, rtol=0
    )


def test_loss_and_gradients_match_jax(pair):
    jmethod, jstate, tmethod, batch = pair
    scene = jmethod.scene

    def loss_fn(params):
        return jmethod._loss(params, _jbatch(batch), jstate.iter_nr, jstate.key, scene)[0]

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(jstate.params)
    tmethod.optimizer.zero_grad(set_to_none=True)
    loss = tmethod._loss(_tbatch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=1e-5, rtol=0)

    for name, ref_state in volsurfs_params_from_jax(_to_numpy(ref_grads)).items():
        params = dict(tmethod.models[name].named_parameters())
        for key, ref_g in ref_state.items():
            g = params[key].grad
            g = np.zeros_like(ref_g.numpy()) if g is None else g.numpy()
            # atol: f32 summation noise (1e-6 of the tensor's largest entry)
            # for entries whose sums cancel to ~0
            scale = float(np.abs(ref_g.numpy()).max())
            np.testing.assert_allclose(
                g, ref_g.numpy(), rtol=1e-4, atol=1e-6 * scale, err_msg=f"{name}.{key}"
            )



def test_three_train_steps_match_jax(pair):
    """Three train steps from the same parameters on the same batch.

    The JAX steps run op by op (``jax.disable_jit``). Under jit, XLA fuses
    the float16 compositing and texture ops and keeps their intermediates
    in float32, which moves JAX's own alpha gradients by up to 4% against
    its op-by-op run; the port rounds every float16 op as written, as the
    op-by-op run does.

    Losses agree within 1e-5 at every step. After 3 steps every entry of
    every tensor agrees within 1e-4, with one exemption in the alpha hash
    tables: an entry whose JAX gradient at some step was below 1e-4 of the
    table's largest. Those gradients are made of float16 cotangents at or
    below float16 resolution (many underflow to 0), and Adam turns any
    nonzero gradient into a step of about lr, so float16 rounding decides
    the sign of a full step there. The other entries that JAX moved in
    each alpha table (2,490 to 3,150 of them) are held."""
    jmethod, jstate, _, batch = pair
    tmethod = _torch_method(jmethod, jstate)
    init = volsurfs_params_from_jax(_to_numpy(jstate.params))
    state = jstate
    first_moments = [volsurfs_params_from_jax(_to_numpy(state.opt_state[0].mu))]
    for step in range(3):
        with jax.disable_jit():
            state, ref = jmethod.train_step(state, _jbatch(batch))
        first_moments.append(volsurfs_params_from_jax(_to_numpy(state.opt_state[0].mu)))
        out = tmethod.train_step(_tbatch(batch))
        np.testing.assert_allclose(
            out["loss"].item(), float(ref["loss"]), atol=1e-5, rtol=0, err_msg=f"step {step}"
        )
    for name, ref_state in volsurfs_params_from_jax(_to_numpy(state.params)).items():
        got = tmethod.models[name].state_dict()
        for key, ref_p in ref_state.items():
            ref_p = ref_p.numpy()
            held = np.ones(ref_p.shape, bool)
            if name.startswith("alpha") and key.endswith("encoding.table"):
                for prev, cur in zip(first_moments[:-1], first_moments[1:]):
                    # JAX's gradient of this step, from Adam's first moment
                    # mu_s = 0.9 mu_{s-1} + 0.1 g_s
                    g = np.abs(cur[name][key].numpy() - 0.9 * prev[name][key].numpy()) / 0.1
                    held &= g > 1e-4 * g.max()
                moved = ref_p != init[name][key].numpy()
                assert not moved.any() or (moved & held).sum() >= 1000, (name, key)
            far = np.abs(got[key].numpy() - ref_p) > 1e-4
            assert not (far & held).any(), (name, key, int((far & held).sum()), int(held.sum()))


def test_optimizer_matches_optax():
    """The port's Adam + warmup + MultiStep schedule against the JAX
    package's optax chain, on the same gradients: the first step runs at
    lr 0 (warmup), a milestone decays the rate by 0.3."""
    from volsurfs_tpu.methods.base import make_optimizer as jax_make_optimizer
    from volsurfs_tpu_torch.methods.base import make_optimizer

    hp = HyperParamsVolSurfs(lr=1e-2, nr_warmup_iters=3, lr_milestones=[5])
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal((64, 8)).astype(np.float32)
    grads = [rng.standard_normal((64, 8)).astype(np.float32) * 10.0**-k for k in range(7)]

    tx = jax_make_optimizer(hp)
    jp = jnp.asarray(p0)
    opt_state = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    optimizer, scheduler = make_optimizer(hp, [tp])
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = jp + updates
        tp.grad = torch.from_numpy(g)
        optimizer.step()
        scheduler.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), atol=1e-6, rtol=0)
    assert not np.allclose(np.asarray(jp), p0)


def _torch_method(jmethod, jstate):
    """A port VolSurfs on the JAX method's shells, with its parameters."""
    fields = {f.name for f in dataclasses.fields(HyperParamsVolSurfs)}
    hp = HyperParamsVolSurfs(**{k: getattr(jmethod.hp, k) for k in fields})
    meshes = [
        (np.asarray(m.verts), np.asarray(m.faces), np.asarray(m.uvs))
        for m in jmethod.tensor_meshes
    ]
    tmethod = VolSurfs(
        hp, meshes, bg_color="white", bounding_primitive=make_bounding_sphere(1.0),
        device="cpu",
    )
    for name, state in volsurfs_params_from_jax(_to_numpy(jstate.params)).items():
        tmethod.models[name].load_state_dict(state)
    return tmethod


def test_config_scene_and_helpers_match_jax():
    """base_5.cfg hyper-parameters, the procedural sphere scene and its
    camera rays, the compositing helpers and the L1 loss."""
    from volsurfs_tpu.datasets import cameras as JC
    from volsurfs_tpu.datasets import synthetic as JS
    from volsurfs_tpu.params.hyper_params import get_method_hyper_params as jax_hp
    from volsurfs_tpu.utils import losses as JL
    from volsurfs_tpu.utils import math as JM
    from volsurfs_tpu_torch.datasets import cameras as TC
    from volsurfs_tpu_torch.datasets import synthetic as TS
    from volsurfs_tpu_torch.params.hyper_params import get_method_hyper_params
    from volsurfs_tpu_torch.utils import losses as TL
    from volsurfs_tpu_torch.utils import math as TM

    cfg = "config/volsurfs/base_5.cfg"
    hp, ref_hp = get_method_hyper_params("volsurfs", cfg), jax_hp("volsurfs", cfg)
    for f in dataclasses.fields(HyperParamsVolSurfs):
        assert getattr(hp, f.name) == getattr(ref_hp, f.name), f.name

    cams, rgbs, masks = TS.make_synthetic_split(3, 32, 32, seed=1)
    ref_cams, ref_rgbs, ref_masks = JS.make_synthetic_split(3, 32, 32, seed=1)
    np.testing.assert_array_equal(rgbs, ref_rgbs)
    np.testing.assert_array_equal(masks, ref_masks)
    for cam, ref_cam in zip(cams, ref_cams):
        np.testing.assert_array_equal(cam.pose, ref_cam.pose)
        rays_o, rays_d = TC.get_camera_rays(cam)
        ref_o, ref_d = JC.get_camera_rays(ref_cam)
        np.testing.assert_allclose(rays_o, np.asarray(ref_o), atol=1e-6)
        np.testing.assert_allclose(rays_d, np.asarray(ref_d), atol=1e-6)

    rng = np.random.default_rng(5)
    x = rng.uniform(0.0, 1.0, (64, 5, 3)).astype(np.float16)
    np.testing.assert_array_equal(
        TM.small_cumprod(TM.take_rev(torch.from_numpy(x), 1), 1).numpy(),
        np.asarray(JM.small_cumprod(JM.take_rev(jnp.asarray(x), 1), 1)),
    )
    a, b = rng.standard_normal((2, 100, 3)).astype(np.float32)
    np.testing.assert_allclose(
        TL.loss_l1(torch.from_numpy(a), torch.from_numpy(b)).item(),
        float(JL.loss_l1(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6,
    )
    np.testing.assert_allclose(
        TM.safe_norm(torch.from_numpy(a)).numpy(), np.asarray(JM.safe_norm(jnp.asarray(a))),
        rtol=1e-6,
    )


def test_ray_batches_sample_the_reel():
    """Batches carry the ground truth of the pixel their ray goes through."""
    from volsurfs_tpu_torch.datasets.cameras import get_camera_rays
    from volsurfs_tpu_torch.datasets.synthetic import make_synthetic_split
    from volsurfs_tpu_torch.datasets.tensor_reel import get_next_rays_batch, make_tensor_reel

    cams, rgbs, masks = make_synthetic_split(4, 16, 16, seed=0)
    reel = make_tensor_reel(cams, rgbs, masks, device="cpu")
    batch = get_next_rays_batch(reel, torch.Generator().manual_seed(0), 64, jitter_pixels=False)
    for i in range(64):
        cam = int(batch["camera_idx"][i])
        rays_o, rays_d = get_camera_rays(cams[cam])
        j = int(np.argmax(rays_d @ batch["rays_d"][i].numpy()))
        np.testing.assert_allclose(batch["rays_d"][i].numpy(), rays_d[j], atol=1e-5)
        np.testing.assert_array_equal(batch["gt_rgb"][i].numpy(), rgbs[cam].reshape(-1, 3)[j])
