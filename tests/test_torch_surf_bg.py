"""The trained background (``bg``) in the port's methods against
volsurfs_tpu's: each method built without ``bg_color`` has it, as in JAX;
surf's render with it on the pair of tests/_torch_surf_pair.py (small
widths, the full 24-level tables, NerfHash at its full width), JAX op by
op; and a checkpoint round trip that carries it. Surf's data step with it:
tests/test_torch_surf_bg_step.py.

Tolerances as tests/test_torch_surf.py's render's (1e-4).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volsurfs_tpu.methods.nerf import NeRF as JNeRF
from volsurfs_tpu.methods.offsets_surfs import OffsetsSurfs as JOffsetsSurfs
from volsurfs_tpu.methods.surf import Surf as JSurf
from volsurfs_tpu.methods.volsurfs import VolSurfs as JVolSurfs
from volsurfs_tpu.ops.raycast import make_bounding_sphere as j_sphere
from volsurfs_tpu.params import hyper_params as JHPs
from volsurfs_tpu_torch.methods.nerf import NeRF
from volsurfs_tpu_torch.methods.offsets_surfs import OffsetsSurfs
from volsurfs_tpu_torch.methods.surf import Surf
from volsurfs_tpu_torch.methods.volsurfs import VolSurfs
from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
from volsurfs_tpu_torch.params import hyper_params as HPs
from volsurfs_tpu_torch.training import checkpoints

from _stage_config import HP as VOLSURFS_HP
from _torch_offsets_pair import HP as OFFSETS_HP
from _torch_surf_pair import DATA_ITER, HP, camera_rays, jax_grid, make_pair

torch.set_num_threads(2)


def _tetra():
    v = np.float32([[0, 0, 0.5], [0.5, 0, -0.3], [-0.4, 0.4, -0.3], [-0.2, -0.5, -0.3]])
    f = np.int32([[0, 1, 2], [0, 2, 3], [0, 3, 1], [1, 3, 2]])
    uv = np.float32([[0.1, 0.1], [0.9, 0.1], [0.5, 0.9], [0.5, 0.5]])
    return v, f, uv


def test_methods_default_to_the_trained_background():
    """Surf, NeRF, OffsetsSurfs and VolSurfs built without bg_color train a
    NerfHash background in both packages; "trained" means the same; a
    constant colour has none."""
    sphere, jsphere = make_bounding_sphere(1.0), j_sphere(1.0)
    tetra = [_tetra()]
    vs_hp = dict(VOLSURFS_HP)
    pairs = [
        (lambda **kw: Surf(HPs.HyperParamsSuRF(**HP), sphere, occupancy_res=8, device="cpu",
                           **kw),
         lambda **kw: JSurf(JHPs.HyperParamsSuRF(**HP), jsphere, occupancy_res=8, **kw)),
        (lambda **kw: NeRF(HPs.HyperParamsNeRF(), sphere, occupancy_res=8, device="cpu", **kw),
         lambda **kw: JNeRF(JHPs.HyperParamsNeRF(), jsphere, occupancy_res=8, **kw)),
        (lambda **kw: OffsetsSurfs(HPs.HyperParamsOffsetsSuRFs(**OFFSETS_HP), sphere,
                                   occupancy_res=8, device="cpu", **kw),
         lambda **kw: JOffsetsSurfs(JHPs.HyperParamsOffsetsSuRFs(**OFFSETS_HP), jsphere,
                                    occupancy_res=8, **kw)),
        (lambda **kw: VolSurfs(HPs.HyperParamsVolSurfs(**vs_hp), tetra,
                               bounding_primitive=sphere, device="cpu", **kw),
         lambda **kw: JVolSurfs(JHPs.HyperParamsVolSurfs(**vs_hp), tetra,
                                bounding_primitive=jsphere, **kw)),
    ]
    for port, ref in pairs:
        for kwargs in ({}, {"bg_color": "trained"}):
            method, jmethod = port(**kwargs), ref(**kwargs)
            assert "bg" in method.models and method.bg_color is None
            assert jmethod.bg_model is not None and jmethod.bg_color is None
            bg = method.models["bg"]
            assert bg.encoder.half_sides is None  # over the contracted space, no box
            assert bg.encoder.nr_levels == 24
        method = port(bg_color="white")
        assert "bg" not in method.models and float(method.bg_color.min()) == 1.0
    with pytest.raises(ValueError, match="bad bg_color"):
        pairs[0][0](bg_color="grey")


@pytest.fixture(scope="module")
def pair():
    return make_pair(bg_color=None)


def test_render_rays_with_the_background_matches_jax(pair):
    jmethod, params, method = pair
    o, d = camera_rays(2)
    ref = jmethod.render_rays(params, jax_grid(jmethod, method.grid), jnp.asarray(o),
                              jnp.asarray(d), DATA_ITER, None, False)
    with torch.no_grad():
        got = method.render_rays(torch.from_numpy(o), torch.from_numpy(d), DATA_ITER)
    assert 0.0 < float(got["bg_transmittance"].mean()) < 1.0
    for name in ("rgb", "rgb_bg", "depth", "weights_sum"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_checkpoint_carries_the_background(pair, tmp_path):
    """A checkpoint holds bg.pt; a fresh Surf (other seed) loaded from it
    renders bit for bit alike."""
    _, _, method = pair
    path = checkpoints.save_checkpoint(str(tmp_path), method)
    fresh = Surf(method.hp, make_bounding_sphere(1.0), occupancy_res=method.occupancy_res,
                 device="cpu", seed=5)
    assert not torch.equal(fresh.models["bg"].encoder.table, method.models["bg"].encoder.table)
    assert "bg.pt" in os.listdir(path)
    checkpoints.load_checkpoint(str(tmp_path), fresh)
    o, d = (torch.from_numpy(x) for x in camera_rays(6))
    ref, got = method.make_render_fn()(o, d), fresh.make_render_fn()(o, d)
    for name in ref:
        assert torch.equal(got[name], ref[name]), name
