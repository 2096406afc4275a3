"""Parity of the port's trained background with volsurfs_tpu's: the
background sampler and the contraction (ops/samplers.py: the plain version
of kernel K10), the ``NerfHash`` field at its full width over contracted
points (negative coordinates included: K6's plain version at lattice
points below 0) and ``render_contracted_bg`` with its gradients. Inputs
come from numpy seeds; JAX runs op by op, with the exact table gradient
(``flat``), and takes the port's random draws.

Tolerances: the samples and the contraction bit for bit (XLA runs each op
alone; the port rounds jnp.linalg.norm as XLA:CPU does,
utils/math.py::norm3). The field 1e-5 (float32 rounding of the same sums
in another order); its gradients 1e-5 of each tensor's L2 norm; the
background's median depth bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volsurfs_tpu.methods.surf import render_contracted_bg as j_render_contracted_bg
from volsurfs_tpu.models import encodings as JE
from volsurfs_tpu.models.fields import NerfHash as JNerfHash
from volsurfs_tpu.ops import raycast as JRC
from volsurfs_tpu.ops import samplers as JSP
from volsurfs_tpu_torch.methods.base import render_contracted_bg
from volsurfs_tpu_torch.models.fields import NerfHash
from volsurfs_tpu_torch.ops import raycast as RC
from volsurfs_tpu_torch.ops import samplers as SP

from _torch_offsets_pair import flat_grads, flax_params

torch.set_num_threads(2)

R, N = 64, 32


def _rays(seed, n=R):
    """Rays from a ring of origins at radius 2 toward the unit sphere, a
    quarter of them aimed past it (t_far 0 on the bounding sphere)."""
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((n, 3))
    o = 2.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-0.5, 0.5, (n, 3)) - o
    d[: n // 4] = o[: n // 4] + rng.uniform(-0.1, 0.1, (n // 4, 3))  # away from the sphere
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _t_far(o, d):
    _, _, t_far, _, _ = RC.make_bounding_sphere(1.0).intersect(torch.from_numpy(o),
                                                               torch.from_numpy(d))
    return t_far[:, None]


@pytest.fixture
def jax_draws(monkeypatch):
    """Serve numpy arrays to JAX's next uniform draws of their shapes."""
    queue = []
    real = jax.random.uniform

    def uniform(key, shape=(), *args, **kwargs):
        if queue and tuple(shape) == queue[0].shape:
            return jnp.asarray(queue.pop(0))
        return real(key, shape, *args, **kwargs)

    monkeypatch.setattr(jax.random, "uniform", uniform)
    return queue


@pytest.mark.parametrize("jitter", [False, True])
def test_background_samples_match_jax(jitter, jax_draws):
    """compute_samples_bg then contract_samples, and K10's plain version
    (the two in one): z, dt, max_dt, the contracted points and distances.
    A quarter of the rays missed the bounding sphere (t_start 0)."""
    o, d = _rays(1)
    t_far = _t_far(o, d)
    assert int((t_far == 0.0).sum()) >= R // 4
    u = np.random.default_rng(2).uniform(0, 1, (R, N)).astype(np.float32) if jitter else None
    if jitter:
        jax_draws.append(u)
    ref = JSP.compute_samples_bg(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_far.numpy()), N,
                                 key=jax.random.PRNGKey(0) if jitter else None)
    j_cpos, j_c = JSP.contract_samples(ref)
    got = SP.compute_samples_bg(torch.from_numpy(o), torch.from_numpy(d), t_far, N,
                                jitter=None if u is None else torch.from_numpy(u))
    for name in ("z", "dt", "max_dt", "mask", "t_near", "t_far"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    cpos, dirs, c_samples, z = SP.bg_samples_reference(
        torch.from_numpy(o), torch.from_numpy(d), t_far, N,
        None if u is None else torch.from_numpy(u))
    np.testing.assert_array_equal(z.numpy(), np.asarray(ref.z))
    np.testing.assert_array_equal(cpos.numpy(), np.asarray(j_cpos))
    for name in ("z", "dt", "max_dt"):
        np.testing.assert_array_equal(getattr(c_samples, name).numpy(),
                                      np.asarray(getattr(j_c, name)), err_msg=name)
    np.testing.assert_array_equal(dirs.numpy(), np.asarray(j_c.dirs()))
    assert float(cpos.norm(dim=-1).max()) <= 1.0
    assert float(cpos.min()) < -0.5  # the field sees negative coordinates


@pytest.mark.parametrize("n", [2, 33, 48])
def test_background_samples_match_jax_at_other_widths(n, jax_draws):
    """K10's plain version against compute_samples_bg then contract_samples
    at 2 samples a ray (no middle sample to jitter) and at 33 and 48 (a
    row not a multiple of a warp on the card), jittered: the depths, the
    contracted points, distances, gaps and max_dt bit for bit."""
    o, d = _rays(6)
    t_far = _t_far(o, d)
    u = np.random.default_rng(n).uniform(0, 1, (R, n)).astype(np.float32)
    jax_draws.append(u)
    ref = JSP.compute_samples_bg(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_far.numpy()), n,
                                 key=jax.random.PRNGKey(0))
    j_cpos, j_c = JSP.contract_samples(ref)
    cpos, dirs, c_samples, z = SP.bg_samples_reference(torch.from_numpy(o), torch.from_numpy(d),
                                                       t_far, n, torch.from_numpy(u))
    np.testing.assert_array_equal(z.numpy(), np.asarray(ref.z))
    np.testing.assert_array_equal(cpos.numpy(), np.asarray(j_cpos))
    for name in ("z", "dt", "max_dt"):
        np.testing.assert_array_equal(getattr(c_samples, name).numpy(),
                                      np.asarray(getattr(j_c, name)), err_msg=name)
    assert c_samples.z.shape == (R, n) and float(cpos.norm(dim=-1).max()) <= 1.0


def test_contraction_matches_jax():
    """contract_points and uncontract_points, on points inside, outside and
    on the contraction's boundary |2p| = 1, and their round trip."""
    rng = np.random.default_rng(3)
    pts = np.concatenate([
        rng.uniform(-0.5, 0.5, (200, 3)), rng.uniform(-50, 50, (200, 3)),
        np.float32([[0.5, 0, 0], [0, -0.5, 0], [0, 0, 0.5], [-0.3, 0.4, 0.0], [0, 0, 0]]),
    ]).astype(np.float32)
    boundary = np.abs(np.linalg.norm(2.0 * pts.astype(np.float64), axis=-1) - 1.0) < 1e-7
    assert boundary.sum() == 4
    c = SP.contract_points(torch.from_numpy(pts))
    np.testing.assert_array_equal(c.numpy(), np.asarray(JSP.contract_points(jnp.asarray(pts))))
    np.testing.assert_array_equal(c.numpy()[boundary], pts[boundary])  # |2p| = 1 stays
    back = SP.uncontract_points(c)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(JSP.uncontract_points(jnp.asarray(c.numpy()))))
    np.testing.assert_allclose(back.numpy(), pts, rtol=2e-3, atol=1e-6)


def test_bounding_primitives_contain_as_jax():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1.2, 1.2, (4096, 3)).astype(np.float32)
    pairs = ((RC.make_bounding_sphere(0.9, (0.1, 0.0, -0.2)),
              JRC.make_bounding_sphere(0.9, (0.1, 0.0, -0.2))),
             (RC.make_bounding_box((1.6, 1.2, 2.0), (0.0, 0.1, 0.0)),
              JRC.make_bounding_box((1.6, 1.2, 2.0), (0.0, 0.1, 0.0))))
    for port, ref in pairs:
        got = port.contains(torch.from_numpy(pts)).numpy()
        np.testing.assert_array_equal(got, np.asarray(ref.contains(jnp.asarray(pts))))
        assert 0.2 < got.mean() < 0.9


def _nerfhash(seed=0):
    """The port's NerfHash at its full width (24 levels, 64-64-64-65 and
    64-64-3), its table drawn in [-0.5, 0.5] from a numpy seed, and JAX's
    with the same parameters."""
    model = NerfHash(bb_sides=None, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        t = model.encoder.table
        t.copy_(torch.from_numpy(np.random.default_rng(seed).uniform(-0.5, 0.5, tuple(t.shape))
                                 .astype(np.float32)))
    return model, JNerfHash(bb_sides=None), flax_params(model)


def _jax_grad(fn, params):
    prev = JE._TABLE_GRAD_MODE
    JE.set_table_grad_mode("flat")
    try:
        return jax.value_and_grad(fn, has_aux=True)(params)
    finally:
        JE.set_table_grad_mode(prev)


def _check_grads(model, ref_tree, rtol=1e-5):
    ref = flat_grads(ref_tree)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(ref)
    for k, r in ref.items():
        err = np.linalg.norm(got[k] - r) / np.linalg.norm(r)
        assert err <= rtol, (k, err)


def test_nerfhash_matches_jax():
    """Forward and every parameter's gradient on 400 contracted points
    (each coordinate of either sign) with their view directions."""
    model, jmodel, params = _nerfhash()
    rng = np.random.default_rng(5)
    pts = SP.contract_points(torch.from_numpy(rng.uniform(-4, 4, (400, 3)).astype(np.float32)))
    pts = pts.numpy()
    assert (pts < 0).any(axis=0).all() and np.abs(pts).max() <= 1.0
    dirs = rng.standard_normal((400, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    w_rgb = rng.standard_normal((400, 3)).astype(np.float32)
    w_den = rng.standard_normal((400, 1)).astype(np.float32)

    def jloss(p):
        rgb, density = jmodel.apply(p, jnp.asarray(pts), jnp.asarray(dirs), 10)
        return jnp.sum(rgb * w_rgb) + jnp.sum(density * w_den), (rgb, density)

    (_, (j_rgb, j_den)), j_grads = _jax_grad(jloss, params)
    rgb, density = model(torch.from_numpy(pts), torch.from_numpy(dirs), 10)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(j_rgb), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(density.detach().numpy(), np.asarray(j_den), rtol=1e-5, atol=1e-6)
    (torch.sum(rgb * torch.from_numpy(w_rgb)) + torch.sum(density * torch.from_numpy(w_den))
     ).backward()
    _check_grads(model, j_grads)


@pytest.mark.parametrize("jitter", [False, True])
def test_render_contracted_bg_matches_jax(jitter, jax_draws):
    """rgb and the (uncontracted) median depth, and the gradients of a
    weighted sum of the rgb with respect to every NerfHash parameter."""
    model, jmodel, params = _nerfhash(1)
    o, d = _rays(6)
    t_far = _t_far(o, d)
    raycast = {"rays_o": torch.from_numpy(o), "rays_d": torch.from_numpy(d), "t_far": t_far}
    jraycast = {"rays_o": jnp.asarray(o), "rays_d": jnp.asarray(d),
                "t_far": jnp.asarray(t_far.numpy())}
    u = np.random.default_rng(7).uniform(0, 1, (R, N)).astype(np.float32)
    if jitter:
        jax_draws.append(u)
    w = np.random.default_rng(8).standard_normal((R, 3)).astype(np.float32)

    def jloss(p):
        res = j_render_contracted_bg(lambda x, y, i: jmodel.apply(p, x, y, i), jraycast, N,
                                     jax.random.PRNGKey(0) if jitter else None, 10)
        return jnp.sum(res["pred_rgb"] * w), res

    (_, ref), j_grads = _jax_grad(jloss, params)
    res = render_contracted_bg(model, raycast, N, torch.from_numpy(u) if jitter else None, 10)
    np.testing.assert_allclose(res["pred_rgb"].detach().numpy(), np.asarray(ref["pred_rgb"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(res["median_depth"].numpy(), np.asarray(ref["median_depth"]))
    torch.sum(res["pred_rgb"] * torch.from_numpy(w)).backward()
    _check_grads(model, j_grads)
