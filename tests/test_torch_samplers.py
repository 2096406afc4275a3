"""Parity of the port's samplers with volsurfs_tpu's: the occupancy grid, the
occupied-space sampler (kernel K7's plain version), the uniform sampler,
``combine`` and the volume-rendering functions (K8, torch ops).

Inputs come from numpy with a seed; the samplers' jitter is fed to JAX by
replacing ``jax.random.uniform`` for the call. JAX runs op by op.

Tolerances: the grid, ``combine`` and the uniform sampler are exact. The
occupied-space sampler sums its occupied arc as count * step (JAX: a tree
of sums), so z agrees to 2e-6 relative + 2e-6 where both masks hold, and
at most 1 mask in 2,000 flips (a target within an ulp of the arc's end);
measured: none at these inputs. Scans run in order here and as trees in
JAX: 2e-6 relative + 1e-6 on the volume-rendering outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volsurfs_tpu.ops import occupancy as JO
from volsurfs_tpu.ops import samplers as JSP
from volsurfs_tpu.ops import samples as JS
from volsurfs_tpu.ops import volume_rendering as JVR
from volsurfs_tpu_torch.ops import occupancy as TO
from volsurfs_tpu_torch.ops import samplers as TSP
from volsurfs_tpu_torch.ops import samples as TS
from volsurfs_tpu_torch.ops import volume_rendering as TVR

torch.set_num_threads(2)

RES = 32
VR_TOL = dict(rtol=2e-6, atol=1e-6)


def _grids(seed=0):
    """The same refreshed grid in both packages: |sdf| of a sphere of
    radius 0.45 plus noise, occupancy at beta 300."""
    rng = np.random.default_rng(seed)
    jg = JO.make_grid(RES, 2.0, sphere_roi_radius=1.0)
    tg = TO.make_grid(RES, 2.0, sphere_roi_radius=1.0)
    centers = np.asarray(jg.get_grid_samples())
    vals = np.abs(np.linalg.norm(centers, axis=-1) - 0.45).astype(np.float32)
    vals += rng.uniform(0.0, 0.02, vals.shape).astype(np.float32)
    jg = jg.update_values(jnp.asarray(vals)).update_occupancy_with_sdf(300.0)
    tg = tg.update_values(torch.from_numpy(vals)).update_occupancy_with_sdf(300.0)
    return jg, tg, rng


def _rays(rng, n):
    o = rng.standard_normal((n, 3)).astype(np.float32)
    o = 2.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + 0.7 * rng.standard_normal((n, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    b = np.sum(o * d, -1)
    disc = b * b - (np.sum(o * o, -1) - 1.0)
    hit = (disc >= 0) & (-b + np.sqrt(np.maximum(disc, 0)) > 0)
    t0 = np.where(hit, np.maximum(-b - np.sqrt(np.maximum(disc, 0)), 0), 0)
    t1 = np.where(hit, -b + np.sqrt(np.maximum(disc, 0)), 0)
    return o, d, t0[:, None].astype(np.float32), t1[:, None].astype(np.float32)


def _fed_uniform(monkeypatch, values):
    """jax.random.uniform returns the given arrays, in order."""
    queue = list(values)

    def fake(key, shape, dtype=jnp.float32, minval=0.0, maxval=1.0):
        v = queue.pop(0)
        assert tuple(v.shape) == tuple(shape), (v.shape, shape)
        return jnp.asarray(v)

    monkeypatch.setattr(jax.random, "uniform", fake)
    return queue


def test_occupancy_grid_matches_jax():
    jg, tg, rng = _grids()
    np.testing.assert_array_equal(tg.roi.numpy(), np.asarray(jg.roi))
    np.testing.assert_array_equal(tg.occupancy.numpy(), np.asarray(jg.occupancy))
    np.testing.assert_array_equal(tg.voxel_centers().numpy(), np.asarray(jg.voxel_centers()))
    assert float(tg.occupancy_fraction()) == pytest.approx(float(jg.occupancy_fraction()))
    assert 0.02 < float(tg.occupancy_fraction()) < 0.5
    pts = rng.uniform(-1.1, 1.1, (20000, 3)).astype(np.float32)
    np.testing.assert_array_equal(tg.check_occupancy(torch.from_numpy(pts)).numpy(),
                                  np.asarray(jg.check_occupancy(jnp.asarray(pts))))


@pytest.mark.parametrize("clip", [False, True])
def test_occupied_samples_match_jax(monkeypatch, clip):
    jg, tg, rng = _grids(1)
    n = 2000
    o, d, t0, t1 = _rays(rng, n)
    jitter = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    _fed_uniform(monkeypatch, [jitter])
    ref = JSP.compute_samples_fg_in_occupied_regions(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t0), jnp.asarray(t1), jg.lookup_fn(),
        1e-4, 3, 64, key=jax.random.PRNGKey(0), clip_to_occupancy=clip)
    got = TSP.compute_samples_fg_in_occupied_regions(
        *(torch.from_numpy(x) for x in (o, d, t0, t1)), tg, 1e-4, 3, 64,
        jitter=torch.from_numpy(jitter), clip_to_occupancy=clip)
    np.testing.assert_array_equal(got.t_near.numpy(), np.asarray(ref.t_near))
    np.testing.assert_array_equal(got.t_far.numpy(), np.asarray(ref.t_far))
    mask, ref_mask = got.mask.numpy(), np.asarray(ref.mask)
    assert mask.sum() > 10 * n  # most rays that hit the sphere took samples
    assert (mask != ref_mask).sum() <= n // 2000
    both = mask & ref_mask
    np.testing.assert_allclose(got.z.numpy()[both], np.asarray(ref.z)[both], rtol=2e-6,
                               atol=2e-6)
    np.testing.assert_allclose(got.max_dt.numpy(), np.asarray(ref.max_dt), rtol=2e-6,
                               atol=1e-9)


def test_uniform_samples_match_jax(monkeypatch):
    rng = np.random.default_rng(2)
    o, d, t0, t1 = _rays(rng, 500)
    jitter = rng.uniform(0, 1, (500, 1)).astype(np.float32)
    _fed_uniform(monkeypatch, [jitter])
    ref = JSP.compute_samples_fg(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t0),
                                 jnp.asarray(t1), 1e-4, 3, 32, key=jax.random.PRNGKey(0))
    got = TSP.compute_samples_fg(*(torch.from_numpy(x) for x in (o, d, t0, t1)), 1e-4, 3, 32,
                                 jitter=torch.from_numpy(jitter))
    for name in ("z", "dt", "mask", "max_dt"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))


def _sample_pair(rng, n, s, t0, t1):
    """Sorted samples with a valid prefix per ray, in both packages."""
    z = np.sort(rng.uniform(t0, t1, (n, s)), axis=1).astype(np.float32)
    count = rng.integers(0, s + 1, (n, 1))
    mask = np.arange(s)[None, :] < count
    z = np.where(mask, z, JS.INVALID_Z).astype(np.float32)
    max_dt = np.full((n, 1), (t1 - t0) / s, np.float32)
    return z, mask, max_dt


def _both_samples(o, d, t0, t1, z, mask, max_dt):
    jsamp = JS.update_dt(JS.RaySamples(
        z=jnp.asarray(z), dt=jnp.zeros_like(jnp.asarray(z)), mask=jnp.asarray(mask),
        rays_o=jnp.asarray(o), rays_d=jnp.asarray(d), t_near=jnp.asarray(t0),
        t_far=jnp.asarray(t1), max_dt=jnp.asarray(max_dt)))
    tsamp = TS.update_dt(TS.RaySamples(
        z=torch.from_numpy(z), dt=torch.zeros(z.shape), mask=torch.from_numpy(mask),
        rays_o=torch.from_numpy(o), rays_d=torch.from_numpy(d), t_near=torch.from_numpy(t0),
        t_far=torch.from_numpy(t1), max_dt=torch.from_numpy(max_dt)))
    return jsamp, tsamp


def test_combine_matches_jax():
    """Merge, the sequential keep-chain dedup (near-equal depths included)
    and the per-sample values: exact."""
    rng = np.random.default_rng(3)
    n = 300
    o, d = np.zeros((n, 3), np.float32), np.tile(np.float32([[0, 0, 1]]), (n, 1))
    t0, t1 = np.full((n, 1), 1.0, np.float32), np.full((n, 1), 3.0, np.float32)
    za, ma, dta = _sample_pair(rng, n, 24, 1.0, 3.0)
    zb, mb, dtb = _sample_pair(rng, n, 12, 1.0, 3.0)
    zb[:, :4] = np.where(mb[:, :4], za[:, :4] + 5e-5, zb[:, :4])  # closer than min_dist
    zb = np.sort(zb, axis=1)
    ja, ta = _both_samples(o, d, t0, t1, za, ma, dta)
    jb, tb = _both_samples(o, d, t0, t1, zb, mb, dtb)
    va = rng.standard_normal((n, 24, 2)).astype(np.float32)
    vb = rng.standard_normal((n, 12, 2)).astype(np.float32)
    ref, ref_v = JS.combine(ja, jb, 1e-4, jnp.asarray(va), jnp.asarray(vb))
    got, got_v = TS.combine(ta, tb, 1e-4, torch.from_numpy(va), torch.from_numpy(vb))
    for name in ("z", "dt", "mask", "max_dt"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))


@pytest.mark.parametrize("kind", ["unsorted", "holes", "ties"])
def test_combine_of_unsorted_and_holed_rows_matches_jax(kind):
    """combine (K8a's plain version) on rows that no sampler gives but the
    kernel must take alike: "unsorted", each set's depths in random order
    (some rows all valid, some with their drawn prefix masks); "holes",
    masks with valid slots after invalid ones; "ties", b's depths copies of
    a's, in the same slots or a slot apart, with values carried: exact."""
    rng = np.random.default_rng({"unsorted": 11, "holes": 12, "ties": 13}[kind])
    n, sa, sb = 128, 40, 24
    o, d = np.zeros((n, 3), np.float32), np.tile(np.float32([[0, 0, 1]]), (n, 1))
    t0, t1 = np.full((n, 1), 1.0, np.float32), np.full((n, 1), 3.0, np.float32)
    za, ma, dta = _sample_pair(rng, n, sa, 1.0, 3.0)
    zb, mb, dtb = _sample_pair(rng, n, sb, 1.0, 3.0)
    if kind == "unsorted":
        za, zb = rng.permuted(za, axis=1), rng.permuted(zb, axis=1)
        ma[::2], mb[1::2] = True, True
    elif kind == "holes":
        ma, mb = rng.uniform(0, 1, (n, sa)) < 0.6, rng.uniform(0, 1, (n, sb)) < 0.6
    else:
        even = (np.arange(n) % 2 == 0)[:, None]
        zb, mb = np.where(even, za[:, :sb], za[:, 1:sb + 1]), np.where(even, ma[:, :sb],
                                                                       ma[:, 1:sb + 1])
    ja, ta = _both_samples(o, d, t0, t1, za, ma, dta)
    jb, tb = _both_samples(o, d, t0, t1, zb, mb, dtb)
    va = rng.standard_normal((n, sa, 3)).astype(np.float32)
    vb = rng.standard_normal((n, sb, 3)).astype(np.float32)
    ref, ref_v = JS.combine(ja, jb, 1e-4, jnp.asarray(va), jnp.asarray(vb))
    got, got_v = TS.combine(ta, tb, 1e-4, torch.from_numpy(va), torch.from_numpy(vb))
    for name in ("z", "dt", "mask", "max_dt"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    assert 0 < got.mask.numpy().sum() < ma.sum() + mb.sum()  # the chain dropped some


def test_volume_rendering_matches_jax(monkeypatch):
    rng = np.random.default_rng(4)
    n, s = 400, 40
    o, d, t0, t1 = _rays(rng, n)
    t1 = np.maximum(t1, t0 + 0.5)
    z, mask, max_dt = _sample_pair(rng, n, s, 0.0, 1.0)
    z = np.where(mask, t0 + z * (t1 - t0), z).astype(np.float32)
    jsamp, tsamp = _both_samples(o, d, t0, t1, z, mask, max_dt * (t1 - t0))
    sdf = (1.0 - z / t1 + 0.05 * rng.standard_normal(z.shape)).astype(np.float32)
    grads = rng.standard_normal((n, s, 3)).astype(np.float32)
    beta, cos_anneal = np.float32(21.5), np.float32(0.35)

    def check(got, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **VR_TOL)

    a_ref = JVR.sdf2alpha(jsamp, jnp.asarray(sdf), beta)
    a_got = TVR.sdf2alpha(tsamp, torch.from_numpy(sdf), float(beta))
    check(a_got, a_ref)
    alpha_ref = JVR.neus_alpha_from_sdf_gradients(jsamp, jnp.asarray(sdf), jnp.asarray(grads),
                                                  cos_anneal, beta)
    alpha = TVR.neus_alpha_from_sdf_gradients(tsamp, torch.from_numpy(sdf),
                                              torch.from_numpy(grads), float(cos_anneal),
                                              float(beta))
    check(alpha, alpha_ref)
    w_ref, t_ref, bg_ref = JVR.neus_weights(jsamp, alpha_ref)
    w, t, bg = TVR.neus_weights(tsamp, alpha)
    for g, r in ((w, w_ref), (t, t_ref), (bg, bg_ref)):
        check(g, r)
    check(TVR.integrate(torch.from_numpy(grads), w, tsamp.mask),
          JVR.integrate(jnp.asarray(grads), w_ref, jsamp.mask))
    check(TVR.sum_over_rays(w, tsamp.mask)[0], JVR.sum_over_rays(w_ref, jsamp.mask)[0])
    check(TVR.median_depth(tsamp, w), JVR.median_depth(jsamp, w_ref))
    w_norm = w / torch.clamp(TVR.sum_over_rays(w, tsamp.mask)[1], min=1e-6)
    w_norm_ref = w_ref / jnp.clip(JVR.sum_over_rays(w_ref, jsamp.mask)[1], 1e-6)
    cdf, cdf_ref = TVR.compute_cdf(w_norm, tsamp.mask), JVR.compute_cdf(w_norm_ref, jsamp.mask)
    check(cdf, cdf_ref)
    for jitter in (None, rng.uniform(-0.5, 0.5, (n, 16)).astype(np.float32)):
        key = None
        if jitter is not None:
            _fed_uniform(monkeypatch, [jitter])
            key = jax.random.PRNGKey(0)
        imp_ref = JVR.importance_sample(jsamp, cdf_ref, 16, key)
        imp = TVR.importance_sample(tsamp, cdf, 16,
                                    None if jitter is None else torch.from_numpy(jitter))
        np.testing.assert_array_equal(imp.mask.numpy(), np.asarray(imp_ref.mask))
        np.testing.assert_allclose(imp.z.numpy(), np.asarray(imp_ref.z), rtol=1e-5, atol=1e-5)


def test_combine_of_the_offsets_paths_shape_matches_jax():
    """combine (K8a's plain version) at the offsets_surfs path's first merge:
    64 + 16 slots carrying K = 5 SDF values, with depths closer than the
    minimum distance, equal depths (a before b), empty rows on either side
    and rows of only invalid slots: exact."""
    rng = np.random.default_rng(8)
    n = 256
    o, d = np.zeros((n, 3), np.float32), np.tile(np.float32([[0, 0, 1]]), (n, 1))
    t0, t1 = np.full((n, 1), 1.0, np.float32), np.full((n, 1), 3.0, np.float32)
    za, ma, dta = _sample_pair(rng, n, 64, 1.0, 3.0)
    zb, mb, dtb = _sample_pair(rng, n, 16, 1.0, 3.0)
    zb[:, :3] = np.where(mb[:, :3] & ma[:, :3], za[:, :3] + 3e-5, zb[:, :3])
    zb[:, 3:5] = np.where(mb[:, 3:5] & ma[:, 3:5], za[:, 3:5], zb[:, 3:5])  # equal depths
    zb = np.sort(zb, axis=1)
    ma[:8], mb[8:16] = False, False  # empty rows
    ma[16:20], mb[16:20] = False, False
    za, zb = np.where(ma, za, JS.INVALID_Z), np.where(mb, zb, JS.INVALID_Z)
    ja, ta = _both_samples(o, d, t0, t1, za.astype(np.float32), ma, dta)
    jb, tb = _both_samples(o, d, t0, t1, zb.astype(np.float32), mb, dtb)
    va = rng.standard_normal((n, 64, 5)).astype(np.float32)
    vb = rng.standard_normal((n, 16, 5)).astype(np.float32)
    ref, ref_v = JS.combine(ja, jb, 1e-4, jnp.asarray(va), jnp.asarray(vb))
    got, got_v = TS.combine(ta, tb, 1e-4, torch.from_numpy(va), torch.from_numpy(vb))
    for name in ("z", "dt", "mask", "max_dt"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    assert 0 < got.mask.numpy().sum() < ma.sum() + mb.sum()  # the chain dropped some


def test_neus_importance_at_five_surfaces_matches_jax(monkeypatch):
    """neus_importance (K8c's plain version) at K = 5 surfaces: its CDF
    (``neus_cdf``) against offsets_surfs' ``_avg_cdf`` (VR_TOL: the scans
    and the average over the surfaces sum in another order), and the
    depths against ``importance_sample`` of that CDF, with and without
    jitter (the masks exact, the depths 1e-5, as above)."""
    from types import SimpleNamespace

    from volsurfs_tpu.methods.offsets_surfs import OffsetsSurfs as JOffsetsSurfs

    rng = np.random.default_rng(9)
    n, s, K = 300, 40, 5
    o, d, t0, t1 = _rays(rng, n)
    t1 = np.maximum(t1, t0 + 0.5)
    z, mask, max_dt = _sample_pair(rng, n, s, 0.0, 1.0)
    z = np.where(mask, t0 + z * (t1 - t0), z).astype(np.float32)
    jsamp, tsamp = _both_samples(o, d, t0, t1, z, mask, max_dt * (t1 - t0))
    base = 1.0 - z / t1 + 0.05 * rng.standard_normal(z.shape)
    offsets = np.float32([0.12, 0.08, 0.04, 0.0, -0.04])
    sdfs = (base[..., None] + offsets).astype(np.float32)
    beta = np.float32(18.5)
    ref_cdf = JOffsetsSurfs._avg_cdf(SimpleNamespace(nr_surfs=K), jsamp, jnp.asarray(sdfs), beta)
    cdf = TVR.neus_cdf(tsamp, torch.from_numpy(sdfs), float(beta))
    np.testing.assert_allclose(cdf.numpy(), np.asarray(ref_cdf), **VR_TOL)
    for jitter in (None, rng.uniform(-0.5, 0.5, (n, 16)).astype(np.float32)):
        key = None
        if jitter is not None:
            _fed_uniform(monkeypatch, [jitter])
            key = jax.random.PRNGKey(0)
        ref = JVR.importance_sample(jsamp, ref_cdf, 16, key)
        got = TVR.neus_importance(tsamp, torch.from_numpy(sdfs), float(beta), 16,
                                  None if jitter is None else torch.from_numpy(jitter))
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
        np.testing.assert_allclose(got.z.numpy(), np.asarray(ref.z), rtol=1e-5, atol=1e-5)


def test_neus_transmittance_backward_matches_jax_grad():
    """The transmittance scan's gradient (K8b's plain version under
    autograd) against jax.grad of JAX's ``neus_weights``, with cotangents
    on the weights, the transmittance and the background transmittance, on
    rows where alpha reaches 1 (the factors then 1e-6, and their products
    underflow to 0): 1e-5 relative + 1e-7."""
    rng = np.random.default_rng(10)
    n, s = 200, 48
    o, d, t0, t1 = _rays(rng, n)
    t1 = np.maximum(t1, t0 + 0.5)
    z, mask, max_dt = _sample_pair(rng, n, s, 0.0, 1.0)
    z = np.where(mask, t0 + z * (t1 - t0), z).astype(np.float32)
    jsamp, tsamp = _both_samples(o, d, t0, t1, z, mask, max_dt * (t1 - t0))
    alpha = rng.uniform(0.0, 0.3, (n, s)).astype(np.float32)
    hard = rng.uniform(0, 1, (n, s)) < 0.15
    alpha[hard] = 1.0  # opaque samples
    alpha[: n // 4, 2:12] = 1.0  # rows that turn opaque, underflowing past ~7 of them
    g_w, g_T = (rng.standard_normal((n, s)).astype(np.float32) for _ in range(2))
    g_bg = rng.standard_normal((n, 1)).astype(np.float32)

    def jax_loss(a):
        w, t, bg = JVR.neus_weights(jsamp, a)
        return jnp.sum(w * g_w) + jnp.sum(t * g_T) + jnp.sum(bg * g_bg)

    ref = jax.grad(jax_loss)(jnp.asarray(alpha))
    a = torch.from_numpy(alpha).requires_grad_(True)
    w, t, bg = TVR.neus_weights(tsamp, a)
    (torch.sum(w * torch.from_numpy(g_w)) + torch.sum(t * torch.from_numpy(g_T))
     + torch.sum(bg * torch.from_numpy(g_bg))).backward()
    assert np.abs(np.asarray(ref)).max() > 1.0 and (t.detach().numpy() == 0).any()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("s", [2, 33, 97])
def test_neus_scan_and_importance_at_row_edges_match_jax(monkeypatch, s):
    """The plain versions the K8b and K8c kernels are held to, at row
    lengths on either side of the kernels' 32-sample chunks, on 64 rays
    with empty, one-sample and full rows: ``neus_transmittance`` forward
    (VR_TOL) and its gradient under autograd against jax.grad of
    ``neus_weights`` (1e-5 relative + 1e-7, as above) on rows where alpha
    reaches 1, and ``neus_importance`` at K = 3 surfaces: its CDF against
    ``_avg_cdf`` (VR_TOL), its depths against ``importance_sample`` of that
    CDF with and without jitter (masks exact, depths 1e-5)."""
    from types import SimpleNamespace

    from volsurfs_tpu.methods.offsets_surfs import OffsetsSurfs as JOffsetsSurfs

    rng = np.random.default_rng(20 + s)
    n, K = 64, 3
    o, d, t0, t1 = _rays(rng, n)
    t1 = np.maximum(t1, t0 + 0.5)
    count = rng.integers(0, s + 1, (n, 1))
    count[:8] = [[0], [0], [1], [1], [s], [s], [s], [min(2, s)]]
    mask = np.arange(s)[None, :] < count
    u = np.sort(rng.uniform(0.0, 1.0, (n, s)), axis=1)
    z = np.where(mask, t0 + u * (t1 - t0), JS.INVALID_Z).astype(np.float32)
    jsamp, tsamp = _both_samples(o, d, t0, t1, z, mask, ((t1 - t0) / s).astype(np.float32))

    alpha = rng.uniform(0.0, 0.3, (n, s)).astype(np.float32)
    alpha[rng.uniform(0, 1, (n, s)) < 0.15] = 1.0
    alpha[::4, 1:13] = 1.0  # opaque runs
    g_w, g_T = (rng.standard_normal((n, s)).astype(np.float32) for _ in range(2))
    g_bg = rng.standard_normal((n, 1)).astype(np.float32)

    def jax_loss(a):
        w, t, bg = JVR.neus_weights(jsamp, a)
        return jnp.sum(w * g_w) + jnp.sum(t * g_T) + jnp.sum(bg * g_bg)

    ref_out = JVR.neus_weights(jsamp, jnp.asarray(alpha))
    ref_grad = jax.grad(jax_loss)(jnp.asarray(alpha))
    a = torch.from_numpy(alpha).requires_grad_(True)
    out = TVR.neus_transmittance(a, tsamp.mask)
    for got, ref in zip(out, ref_out):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **VR_TOL)
    (torch.sum(out[0] * torch.from_numpy(g_w)) + torch.sum(out[1] * torch.from_numpy(g_T))
     + torch.sum(out[2] * torch.from_numpy(g_bg))).backward()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ref_grad), rtol=1e-5, atol=1e-7)

    base = 1.0 - z / t1 + 0.05 * rng.standard_normal(z.shape)
    sdfs = (base[..., None] + np.float32([0.04, 0.0, -0.04])).astype(np.float32)
    beta = np.float32(18.5)
    ref_cdf = JOffsetsSurfs._avg_cdf(SimpleNamespace(nr_surfs=K), jsamp, jnp.asarray(sdfs), beta)
    cdf = TVR.neus_cdf(tsamp, torch.from_numpy(sdfs), float(beta))
    np.testing.assert_allclose(cdf.numpy(), np.asarray(ref_cdf), **VR_TOL)
    for jitter in (None, rng.uniform(-0.5, 0.5, (n, 16)).astype(np.float32)):
        key = None
        if jitter is not None:
            _fed_uniform(monkeypatch, [jitter])
            key = jax.random.PRNGKey(0)
        ref = JVR.importance_sample(jsamp, ref_cdf, 16, key)
        got = TVR.neus_importance(tsamp, torch.from_numpy(sdfs), float(beta), 16,
                                  None if jitter is None else torch.from_numpy(jitter))
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
        np.testing.assert_allclose(got.z.numpy(), np.asarray(ref.z), rtol=1e-5, atol=1e-5)
