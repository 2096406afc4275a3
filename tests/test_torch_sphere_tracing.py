"""Parity of the port's sphere tracer with volsurfs_tpu's: ``sphere_trace``
on an analytic sphere SDF (written once in jnp and once in torch) inside a
bounding sphere or box, without and with an occupancy grid (24^3, where the
coarse 4^3 pooling acts, and 22^3, where it does not), and Surf's
``render_rays_sphere_traced`` (``make_render_fn(sphere_traced=True)``) on a
small surf model with the trained background. The port's march step is
the plain version of kernel K9 here.

JAX marches under a jitted ``lax.while_loop``, whose fusions contract
products and sums into fmas that the port (op by op, as the kernel) does
not, so its depths differ in the last bits: the hits and the step counts
must be equal, the depths within 1e-5 (about 40 float32 ulps at depth 2;
measured below 1e-6). The render's rgb and depth within 1e-4, its normals
1e-3 (tests/test_torch_surf.py's tolerances and reasons).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volsurfs_tpu.ops import raycast as JRC
from volsurfs_tpu.ops.occupancy import OccupancyGrid as JGrid
from volsurfs_tpu.ops.sphere_tracing import sphere_trace as j_sphere_trace
from volsurfs_tpu_torch.ops import raycast as RC
from volsurfs_tpu_torch.ops import sphere_tracing as ST
from volsurfs_tpu_torch.ops.occupancy import make_grid
from volsurfs_tpu_torch.utils.math import norm3

from _torch_surf_pair import DATA_ITER, camera_rays, jax_grid, make_pair

torch.set_num_threads(2)

RADIUS = 0.5
CENTER = np.float32([0.05, -0.03, 0.02])


def _sdf_torch(p):
    return (norm3(p - torch.from_numpy(CENTER)) - RADIUS)[:, None]


def _sdf_jax(p):
    return jnp.linalg.norm(p - jnp.asarray(CENTER), axis=-1, keepdims=True) - RADIUS


def _grids(res):
    """The port's and JAX's occupancy grid of res^3 voxels over [-1, 1]^3:
    occupied within 1.5 voxels of the sphere, the ROI the unit ball."""
    grid = make_grid(res, 2.0, sphere_roi_radius=1.0)
    d = np.abs(np.linalg.norm(grid.voxel_centers().numpy() - CENTER, axis=-1) - RADIUS)
    occ = torch.from_numpy(d.reshape((res,) * 3) < 1.5 * 2.0 / res)
    grid = type(grid)(grid.values, occ, grid.roi, grid.extent)
    jgrid = JGrid(values=jnp.asarray(grid.values.numpy()), occupancy=jnp.asarray(occ.numpy()),
                  roi=jnp.asarray(grid.roi.numpy()), extent=jnp.asarray(grid.extent))
    return grid, jgrid


def _rays(seed, n=512):
    """Camera rays at distance 2 toward the sphere, a third of them missing
    it, some grazing it."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.float32([[0.0, 0.0, -2.0]]), (n, 1))
    d = rng.normal(0, 0.22, (n, 3)).astype(np.float32) + np.float32([0, 0, 1])
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("case", ["sphere", "box", "grid24", "grid22"])
def test_sphere_trace_matches_jax(case):
    o, d = _rays(1)
    if case == "box":
        bound, jbound = RC.make_bounding_box(1.8), JRC.make_bounding_box(1.8)
    else:
        bound, jbound = RC.make_bounding_sphere(1.0), JRC.make_bounding_sphere(1.0)
    grid = jgrid = None
    if case.startswith("grid"):
        grid, jgrid = _grids(int(case[4:]))
    kwargs = dict(nr_sphere_traces=24, sdf_converged_tresh=1e-3, min_step=8e-3)
    ref = j_sphere_trace(_sdf_jax, jnp.asarray(o), jnp.asarray(d), jbound,
                         occupancy_grid=jgrid, **kwargs)
    ST.launches["sphere_trace_step_reference"] = 0
    got = ST.sphere_trace(_sdf_torch, torch.from_numpy(o), torch.from_numpy(d), bound,
                          occupancy_grid=grid, **kwargs)
    assert ST.launches["sphere_trace_step_reference"] == got["steps"]
    hit = np.asarray(ref["is_hit"])
    assert 0.3 < hit.mean() < 0.9  # hits and misses both
    np.testing.assert_array_equal(got["is_hit"].numpy(), hit)
    assert got["steps"] == int(ref["steps"])
    np.testing.assert_allclose(got["z"].numpy()[hit], np.asarray(ref["z"])[hit], rtol=0,
                               atol=1e-5)
    # the hits lie on the sphere
    r = np.linalg.norm(got["positions"].numpy()[hit] - CENTER, axis=-1)
    assert np.abs(r - RADIUS).max() < 2e-3


@pytest.fixture(scope="module")
def pair():
    return make_pair(bg_color=None)


def test_render_rays_sphere_traced_matches_jax(pair):
    """The sphere-traced render of a small surf model (the occupancy grid
    refreshed at DATA_ITER, the trained background): rgb, depth, normals
    and the hit mask (weights_sum) against JAX's."""
    jmethod, params, method = pair
    o, d = camera_rays(2)
    ref = jmethod.render_rays_sphere_traced(params, jax_grid(jmethod, method.grid),
                                            jnp.asarray(o), jnp.asarray(d), DATA_ITER)
    got = method.make_render_fn(sphere_traced=True)(torch.from_numpy(o), torch.from_numpy(d))
    hit = np.asarray(ref["weights_sum"])[:, 0] > 0.5
    assert 0.1 < hit.mean() < 0.95  # surface and background both
    np.testing.assert_array_equal(got["weights_sum"].numpy(), np.asarray(ref["weights_sum"]))
    for name in ("rgb", "depth"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_allclose(got["normals"].numpy(), np.asarray(ref["normals"]), rtol=1e-3,
                               atol=1e-3)


def _random_surf(res):
    """A small random surf SDF (the full 24-level table, an MLP 16-16) and
    its occupancy grid refreshed at res^3 (None without a grid)."""
    from volsurfs_tpu_torch.methods.surf import Surf
    from volsurfs_tpu_torch.params.hyper_params import HyperParamsSuRF

    hp = HyperParamsSuRF(appearance_predict_sh_coeffs=True, sdf_mlp_layers_dims=[16, 16],
                         geom_feat_size=8, rgb_mlp_layers_dims=[32, 32], sh_degree=2,
                         init_phase_end_iter=10, first_phase_end_iter=100,
                         use_occupancy_grid=res > 0)
    method = Surf(hp, RC.make_bounding_sphere(1.0), bg_color="white", occupancy_res=res or 8,
                  device="cpu", seed=3)
    table = method.models["sdf"].encoder.table
    with torch.no_grad():
        table.copy_(torch.from_numpy(np.random.default_rng(res).uniform(
            -0.05, 0.05, tuple(table.shape)).astype(np.float32)))
    method.iter_nr = 30
    if res:
        method.update_occupancy_grid()

    def sdf(p):
        with torch.no_grad():
            return method._sdf(p, method.iter_nr)[0][:, 0]

    return sdf, method.grid if res else None


@pytest.mark.parametrize("res", [0, 24, 22])
@pytest.mark.parametrize("field", ["sphere", "surf"])
def test_compacted_march_equals_the_lockstep_march(field, res):
    """The compacted march (the active rays only, the plain step on the
    CPU) against JAX's lockstep loop with the plain step: t, hit, refining
    and converged of every ray and the steps bit for bit, without a grid
    and with a 24^3 grid (the coarse 4^3 level on) and a 22^3 one (off)."""
    o, d = (torch.from_numpy(x) for x in _rays(5, n=1024))
    if field == "sphere":
        grid = _grids(res)[0] if res else None
        sdf = lambda p: _sdf_torch(p)[:, 0]  # noqa: E731
    else:
        sdf, grid = _random_surf(res)
    space = ST.trace_space(RC.make_bounding_sphere(1.0), 1e-3, 8e-3, grid)
    compact, steps = ST.march(sdf, o, d, space, 24)
    lockstep, lockstep_steps = ST.march_lockstep_reference(sdf, o, d, space, 24)
    assert steps == lockstep_steps
    for k, name in ((0, "t"), (5, "refining"), (6, "hit"), (7, "converged")):
        assert torch.equal(compact[k], lockstep[k]), name
    hit = compact[6] | compact[5]
    assert 0.05 < float(hit.float().mean()) < 0.95  # hits and misses both
