"""Parity of the port's permutohedral encoder (kernel K6's plain version)
with volsurfs_tpu's PermutoEncoder: 24 levels, 4,096 points, features,
their Jacobian, the table gradient from both cotangents and the points'
gradient.

The elevation rounds as XLA:CPU's dot (fma(p2, W2, fma(p1, W1, p0 * W0))),
so every (point, level) picks JAX's simplex: the count of pairs whose
simplex differs, read from dfeats (a different simplex changes a level's
Jacobian by far more than rounding), is 0. Tolerances, all float32
rounding: feats and dfeats 1e-6 relative + 1e-6 (the corner sums may be
fused by XLA); the table gradient 1e-5 of the absolute sum of each row's
updates (the scatter sums in another order); the points' gradient 1e-6 of
its largest entry (a sum of 96 terms a point; measured 1.05e-7)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volsurfs_tpu.models import encodings as JE
from volsurfs_tpu_torch.convert import module_state_from_flax
from volsurfs_tpu_torch.models import encodings as TE
from volsurfs_tpu_torch.ops import permuto as P

from _permuto_points import kinds_of_points

torch.set_num_threads(2)

N = 4096
FEAT_TOL = dict(rtol=1e-6, atol=1e-6)


def _setup(seed, c2f_iters=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 1.0, (N, 3)).astype(np.float32)
    pts[:32] *= 1.2  # some out of the box
    jmod = JE.PermutoEncoder(nr_iters_for_c2f=c2f_iters)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(pts[:4]))
    table = rng.uniform(-0.5, 0.5, params["params"]["table"].shape).astype(np.float32)
    params = {"params": {"table": table}}
    tmod = TE.PermutoEncoder(nr_iters_for_c2f=c2f_iters)
    tmod.load_state_dict(module_state_from_flax(params))
    return rng, pts, jmod, params, tmod


def _flat_vjp(fn, params, cot):
    prev = JE._TABLE_GRAD_MODE
    JE.set_table_grad_mode("flat")  # exact f32 scatter on the JAX side
    try:
        out, vjp = jax.vjp(fn, params)
        (grad,) = vjp(cot)
    finally:
        JE.set_table_grad_mode(prev)
    return out, np.asarray(grad["params"]["table"])


def _row_bound(tmod, pts, upd_abs_scale):
    """1e-5 of the absolute sum of each row's updates, from the port's rows."""
    unit = (torch.from_numpy(pts) / tmod.half_sides + 1.0) / 2.0
    _, _, idx, _, _ = P.permuto_forward_reference(
        unit, tmod.table.detach(), tmod.W, tmod.level_sizes, tmod.level_offsets)
    rows = idx.reshape(-1).long()
    w = torch.zeros(tmod.total_rows)
    w.index_add_(0, rows, torch.ones_like(rows, dtype=torch.float32))
    return 1e-5 * upd_abs_scale * w.numpy()[:, None] + 1e-7


def test_level_layout_and_projection_match_jax():
    jmod = JE.PermutoEncoder()
    tmod = TE.PermutoEncoder()
    assert tmod.sizes == jmod._level_sizes()
    assert tmod.total_rows == 3898240
    offsets, total_rows = TE._level_layout(tmod.sizes)
    np.testing.assert_array_equal(offsets, JE._level_layout(jmod._level_sizes())[0])


@pytest.mark.parametrize("c2f_iters", [0, 100])
def test_permuto_forward_and_table_grad_match_jax(c2f_iters):
    rng, pts, jmod, params, tmod = _setup(0, c2f_iters)
    it = 30 if c2f_iters else None
    cot = rng.standard_normal((N, tmod.output_dim)).astype(np.float32)
    ref, ref_grad = _flat_vjp(lambda p: jmod.apply(p, jnp.asarray(pts), it)[0], params,
                              jnp.asarray(cot))
    feats, oob = tmod(torch.from_numpy(pts), it)
    np.testing.assert_allclose(feats.detach().numpy(), np.asarray(ref), **FEAT_TOL)
    np.testing.assert_array_equal(oob.numpy(), np.asarray(jmod.apply(params, jnp.asarray(pts))[1]))
    (grad,) = torch.autograd.grad(feats, tmod.table, torch.from_numpy(cot))
    bound = _row_bound(tmod, pts, np.abs(cot).max())
    assert (np.abs(grad.numpy() - ref_grad) <= bound).all()


def test_permuto_jacobian_and_table_grad_match_jax():
    rng, pts, jmod, params, tmod = _setup(1, 100)
    it = 45
    cot_f = rng.standard_normal((N, tmod.output_dim)).astype(np.float32)
    cot_d = rng.standard_normal((3, N, tmod.output_dim)).astype(np.float32)
    (ref_f, ref_d), ref_grad = _flat_vjp(
        lambda p: jmod.apply(p, jnp.asarray(pts), it, with_grads=True)[:2], params,
        (jnp.asarray(cot_f), jnp.asarray(cot_d)))
    feats, dfeats, _ = tmod(torch.from_numpy(pts), it, with_grads=True)
    np.testing.assert_allclose(feats.detach().numpy(), np.asarray(ref_f), **FEAT_TOL)
    # (point, level) pairs whose simplex differs from JAX's: none
    d_err = np.abs(dfeats.detach().numpy() - np.asarray(ref_d))[..., :48]
    scale = np.abs(np.asarray(ref_d))[..., :48]
    differ = (d_err > 1e-4 * scale + 1e-4).reshape(3, N, 24, 2).any(axis=(0, 3))
    assert int(differ.sum()) == 0
    np.testing.assert_allclose(dfeats.detach().numpy(), np.asarray(ref_d), **FEAT_TOL)
    (grad,) = torch.autograd.grad((feats, dfeats), tmod.table,
                                  (torch.from_numpy(cot_f), torch.from_numpy(cot_d)))
    # an update sums bary * cot and dbary * cot over 3 axes: |dbary| <= 2 / (8 scale)
    dbary_max = float(tmod.ddiff.abs().max()) * 2
    bound = _row_bound(tmod, pts, np.abs(cot_f).max() + 3 * dbary_max * np.abs(cot_d).max())
    assert (np.abs(grad.numpy() - ref_grad) <= bound).all()


def test_permuto_updates_match_autograd_of_the_plain_sums():
    """The plain backward's per-corner updates, scattered, equal the
    autograd gradient of the plain forward written with a differentiable
    table gather (the same sums), and so does its points' gradient."""
    rng, pts, _, _, tmod = _setup(2)
    pts = pts[:512]
    unit = ((torch.from_numpy(pts) / tmod.half_sides + 1.0) / 2.0).requires_grad_(True)
    table = tmod.table.detach().clone().requires_grad_(True)
    feats, dfeats, idx, bary, code = P.permuto_forward_reference(
        unit, table, tmod.W, tmod.level_sizes, tmod.level_offsets, tmod.ddiff)
    cot_f = torch.from_numpy(rng.standard_normal(tuple(feats.shape)).astype(np.float32))
    cot_d = torch.from_numpy(rng.standard_normal(tuple(dfeats.shape)).astype(np.float32))
    ref, ref_unit = torch.autograd.grad((feats, dfeats), (table, unit), (cot_f, cot_d))
    upd, d_unit = P.permuto_backward_reference(idx, bary.detach(), code, cot_f, tmod.ddiff,
                                               cot_d, table.detach(), tmod.W)
    # autograd sums in another order (and through the mean's exact zero)
    assert float((d_unit - ref_unit).abs().max()) <= 1e-6 * float(ref_unit.abs().max())
    got = torch.zeros_like(ref).index_add_(0, idx.reshape(-1).long(), upd)
    # the two sum the terms of an update, and a row's updates, in other orders
    dbary_max = float(tmod.ddiff.abs().max()) * 2
    bound = _row_bound(tmod, pts, float(cot_f.abs().max())
                       + 3 * dbary_max * float(cot_d.abs().max()))
    assert (np.abs((got - ref).numpy()) <= bound).all()


@pytest.mark.parametrize("with_grads", [False, True])
def test_permuto_points_grad_matches_jax(with_grads):
    """The points' gradient (the features' cotangent through the weights,
    JAX's d_bary; dfeats is constant in the points) against jax.vjp in the
    points, through the encoder's training path."""
    rng, pts, jmod, params, tmod = _setup(4, 100)
    it = 45
    cot_f = rng.standard_normal((N, tmod.output_dim)).astype(np.float32)
    cot_d = rng.standard_normal((3, N, tmod.output_dim)).astype(np.float32)
    if with_grads:
        _, vjp = jax.vjp(lambda p: jmod.apply(params, p, it, with_grads=True)[:2],
                         jnp.asarray(pts))
        (ref,) = vjp((jnp.asarray(cot_f), jnp.asarray(cot_d)))
    else:
        _, vjp = jax.vjp(lambda p: jmod.apply(params, p, it)[0], jnp.asarray(pts))
        (ref,) = vjp(jnp.asarray(cot_f))
    points = torch.from_numpy(pts).requires_grad_(True)
    P.launches["permuto_bwd_reference"] = 0
    out = tmod(points, it, with_grads=with_grads)
    outs, cots = (out[:2], (cot_f, cot_d)) if with_grads else (out[0], (cot_f,))
    (got,) = torch.autograd.grad(outs, points, tuple(torch.from_numpy(c) for c in cots))
    assert P.launches["permuto_bwd_reference"] == 1
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("kind", ["ball", "refresh", "outside"])
def test_permuto_lookup_grads_match_jax_at_the_paths_kinds_of_points(kind):
    """PermutoLookupWithGrad's table and points' gradients on the CPU (the
    fused backward's plain version, which recomputes the rows and weights
    from the points) against jax.vjp at the surf stage's kinds of points:
    samples in the bounding ball with 16 at the invalid samples' depth
    (1e10: their lattice keys pass 2^31, where the float-to-int conversion
    saturates as XLA's does), an occupancy refresh's voxel centres, points
    outside the box."""
    rng = np.random.default_rng(7)
    pts = kinds_of_points(rng, kind)
    n = pts.shape[0]
    jmod = JE.PermutoEncoder(nr_iters_for_c2f=100)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(pts[:4]))
    table = rng.uniform(-0.5, 0.5, params["params"]["table"].shape).astype(np.float32)
    params = {"params": {"table": table}}
    tmod = TE.PermutoEncoder(nr_iters_for_c2f=100)
    tmod.load_state_dict(module_state_from_flax(params))
    it = 45
    cot_f = rng.standard_normal((n, tmod.output_dim)).astype(np.float32)
    cot_d = rng.standard_normal((3, n, tmod.output_dim)).astype(np.float32)
    prev = JE._TABLE_GRAD_MODE
    JE.set_table_grad_mode("flat")
    try:
        _, vjp = jax.vjp(lambda p, x: jmod.apply(p, x, it, with_grads=True)[:2], params,
                         jnp.asarray(pts))
        ref_params, ref_pts = vjp((jnp.asarray(cot_f), jnp.asarray(cot_d)))
    finally:
        JE.set_table_grad_mode(prev)
    points = torch.from_numpy(pts).requires_grad_(True)
    feats, dfeats, _ = tmod(points, it, with_grads=True)
    grad_table, grad_pts = torch.autograd.grad(
        (feats, dfeats), (tmod.table, points), (torch.from_numpy(cot_f), torch.from_numpy(cot_d)))
    dbary_max = float(tmod.ddiff.abs().max()) * 2
    bound = _row_bound(tmod, pts, np.abs(cot_f).max() + 3 * dbary_max * np.abs(cot_d).max())
    assert (np.abs(grad_table.numpy() - np.asarray(ref_params["params"]["table"])) <= bound).all()
    ref_pts = np.asarray(ref_pts)
    assert np.abs(grad_pts.numpy() - ref_pts).max() <= 1e-6 * np.abs(ref_pts).max()


@pytest.mark.parametrize("with_grads", [False, True])
@pytest.mark.parametrize("want_unit", [False, True])
def test_permuto_fused_backward_plain_is_per_corner_backward_and_scatter(with_grads, want_unit):
    """The fused backward's plain version (what a CPU tensor runs) is
    permuto_backward_reference followed by scatter_add_rows_reference, bit
    for bit, and gives only the gradients asked for."""
    from volsurfs_tpu_torch.ops.scatter_add import scatter_add_rows_reference

    rng, pts, _, _, tmod = _setup(5)
    unit = (torch.from_numpy(pts[:1024]) / tmod.half_sides + 1.0) / 2.0
    n, L = unit.shape[0], tmod.nr_levels
    ddiff = tmod.ddiff if with_grads else None
    lookup = (unit, tmod.table.detach(), tmod.W, tmod.level_sizes, tmod.level_offsets)
    _, _, idx, bary, code = P.permuto_forward_reference(*lookup, ddiff)
    dout = torch.from_numpy(rng.standard_normal((n, 2 * L)).astype(np.float32))
    gd = (torch.from_numpy(rng.standard_normal((3, n, 2 * L)).astype(np.float32))
          if with_grads else None)
    upd, d_unit_ref = P.permuto_backward_reference(
        idx, bary, code, dout, ddiff, gd, tmod.table.detach() if want_unit else None, tmod.W)
    d_table_ref = scatter_add_rows_reference(idx.reshape(-1), upd, tmod.total_rows)
    d_table, d_unit = P.permuto_backward(*lookup, dout, ddiff, gd, want_unit=want_unit)
    assert torch.equal(d_table, d_table_ref)
    assert (d_unit is None) == (not want_unit)
    if want_unit:
        assert torch.equal(d_unit, d_unit_ref)
    none, d_unit_only = P.permuto_backward(*lookup, dout, ddiff, gd, want_table=False,
                                           want_unit=want_unit)
    assert none is None and (d_unit_only is None or torch.equal(d_unit_only, d_unit_ref))


def test_permuto_lookup_with_grad_table_and_points_grads_match_jax():
    """One backward of PermutoLookupWithGrad (through the encoder's
    training path) gives the table's and the points' gradients together,
    each at the tolerance of its own test above."""
    rng, pts, jmod, params, tmod = _setup(6, 100)
    it = 45
    cot_f = rng.standard_normal((N, tmod.output_dim)).astype(np.float32)
    cot_d = rng.standard_normal((3, N, tmod.output_dim)).astype(np.float32)
    prev = JE._TABLE_GRAD_MODE
    JE.set_table_grad_mode("flat")
    try:
        _, vjp = jax.vjp(lambda p, x: jmod.apply(p, x, it, with_grads=True)[:2], params,
                         jnp.asarray(pts))
        ref_params, ref_pts = vjp((jnp.asarray(cot_f), jnp.asarray(cot_d)))
    finally:
        JE.set_table_grad_mode(prev)
    points = torch.from_numpy(pts).requires_grad_(True)
    feats, dfeats, _ = tmod(points, it, with_grads=True)
    grad_table, grad_pts = torch.autograd.grad(
        (feats, dfeats), (tmod.table, points), (torch.from_numpy(cot_f), torch.from_numpy(cot_d)))
    dbary_max = float(tmod.ddiff.abs().max()) * 2
    bound = _row_bound(tmod, pts, np.abs(cot_f).max() + 3 * dbary_max * np.abs(cot_d).max())
    assert (np.abs(grad_table.numpy() - np.asarray(ref_params["params"]["table"])) <= bound).all()
    ref_pts = np.asarray(ref_pts)
    assert np.abs(grad_pts.numpy() - ref_pts).max() <= 1e-6 * np.abs(ref_pts).max()
