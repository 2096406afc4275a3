"""Rules of the torch port: it imports nothing of JAX or of the JAX package,
it does not fall back to the CPU when CUDA is asked for, and CPU tensors go
to the plain versions of its kernels."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from volsurfs_tpu_torch.datasets import baked_scene
from volsurfs_tpu_torch.datasets.cameras import Camera
from volsurfs_tpu_torch.methods import volsurfs as TV
from volsurfs_tpu_torch.ops import bvh as TB
from volsurfs_tpu_torch.ops import permuto as P
from volsurfs_tpu_torch.ops import samplers as SP
from volsurfs_tpu_torch.ops import scatter_add as S
from volsurfs_tpu_torch.ops import shade as SH
from volsurfs_tpu_torch.renderers.mesh_renderer import BakedMeshRenderer
from volsurfs_tpu_torch.params.hyper_params import HyperParamsSuRF, HyperParamsVolSurfs

torch.set_num_threads(2)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
FORBIDDEN = ("jax", "flax", "optax", "volsurfs_tpu")


def _port_files():
    files = [os.path.join(REPO, name)
             for name in ("chip_smoke.py", "chip_compare.py", "chip_stage_runs.py")]
    for root, _, names in os.walk(os.path.join(REPO, "volsurfs_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax_or_jax_package():
    files = _port_files()
    assert len(files) > 10
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in FORBIDDEN:  # exact top-level match: volsurfs_tpu_torch passes
                bad.append((os.path.relpath(path, REPO), mod))
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'volsurfs_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import volsurfs_tpu_torch\n"
        "import volsurfs_tpu_torch.methods.volsurfs, volsurfs_tpu_torch.convert\n"
        "import volsurfs_tpu_torch.datasets.synthetic, volsurfs_tpu_torch.datasets.tensor_reel\n"
        "import volsurfs_tpu_torch.renderers.mesh_renderer, volsurfs_tpu_torch.renderers.viewer\n"
        "import volsurfs_tpu_torch.datasets.mvdataset, volsurfs_tpu_torch.datasets.baked_scene\n"
        "import volsurfs_tpu_torch.utils.png, volsurfs_tpu_torch.utils.evaluation\n"
        "import volsurfs_tpu_torch.utils.rendering, volsurfs_tpu_torch.params.params\n"
        "import volsurfs_tpu_torch.training.trainer, volsurfs_tpu_torch.training.checkpoints\n"
        "import volsurfs_tpu_torch.training.callbacks, volsurfs_tpu_torch.baking.baker\n"
        "import volsurfs_tpu_torch.methods.surf, volsurfs_tpu_torch.models.fields\n"
        "import volsurfs_tpu_torch.models.field_utils, volsurfs_tpu_torch.ops.permuto\n"
        "import volsurfs_tpu_torch.ops.samplers, volsurfs_tpu_torch.ops.volume_rendering\n"
        "import volsurfs_tpu_torch.ops.occupancy, volsurfs_tpu_torch.ops.samples\n"
        "import volsurfs_tpu_torch.methods.offsets_surfs, volsurfs_tpu_torch.pipeline\n"
        "import volsurfs_tpu_torch.baking.marching, volsurfs_tpu_torch.baking.tsdf\n"
        "import volsurfs_tpu_torch.baking.simplify, volsurfs_tpu_torch.baking.uv_atlas\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _tetra():
    verts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32) - 0.3
    faces = np.asarray([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.int32)
    uvs = verts[:, :2] + 0.5
    return verts, faces, uvs


def test_volsurfs_without_device_needs_cuda(monkeypatch):
    """The default device is CUDA; without it the constructor raises instead
    of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hp = HyperParamsVolSurfs(
        using_neural_textures=True, appearance_predict_sh_coeffs=True,
        rgb_normal_dep=False, transp_normal_dep=False, sh_degree=0,
    )
    with pytest.raises(RuntimeError, match="cuda"):
        TV.VolSurfs(hp, [_tetra()])


def test_cpu_tensors_take_the_plain_versions():
    for counts in (S.launches, TB.launches):
        for key in counts:
            counts[key] = 0
    rows = torch.tensor([0, 3, 3], dtype=torch.int32)
    out = S.scatter_add_rows(rows, torch.ones(3, 2), 4)
    np.testing.assert_array_equal(out.numpy(), [[1, 1], [0, 0], [0, 0], [2, 2]])
    v, f, _ = _tetra()
    stacked = TB.stack_bvhs([TB.build_bvh(v, f)], "cpu")
    hits = TB.trace_all(
        stacked, torch.tensor([[0.0, 0.0, -2.0]]), torch.tensor([[0.0, 0.0, 1.0]])
    )
    assert bool(hits["is_hit"][0, 0])
    assert S.launches == {"scatter_add": 0, "scatter_add_reference": 1}
    assert TB.launches == {"bvh_trace": 0, "bvh_trace_reference": 1}


def test_baked_renderer_without_device_needs_cuda(monkeypatch):
    """BakedMeshRenderer's default device is CUDA; without it the
    constructor raises instead of rendering on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        BakedMeshRenderer(baked_scene.COMMITTED_SCENE)


def test_cpu_rays_take_the_plain_shading(tmp_path):
    """A renderer on the CPU shades through _shade_composite_reference (the
    plain version of K4), for render_rays and the frame entry points."""
    for counts in (SH.launches, TB.launches):
        for key in counts:
            counts[key] = 0
    v, f, uv = _tetra()
    obj = str(tmp_path / "tetra.obj")
    from volsurfs_tpu_torch.baking.mesh_io import save_obj

    save_obj(obj, v, f, uv)
    baked_scene.write_random_scene(str(tmp_path / "scene"), [obj], (4, 2), 1)
    r = BakedMeshRenderer(str(tmp_path / "scene"), device="cpu")
    out = r.render_rays(torch.tensor([[0.1, 0.1, -2.0]]), torch.tensor([[0.0, 0.0, 1.0]]))
    assert out["rgb"].shape == (1, 3) and float(out["bg_transmittance"][0, 0]) < 1.0
    cam = Camera(intrinsics=np.asarray([[8.0, 0, 4], [0, 8.0, 4], [0, 0, 1]], np.float32),
                 pose=np.asarray([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, -2], [0, 0, 0, 1]],
                                 np.float32), width=8, height=8)
    imgs, overflow = r.render_frames_device([cam])
    assert not imgs.is_cuda and imgs.shape == (1, 8, 8, 3) and overflow.tolist() == [0, 0, 0]
    assert SH.launches == {"shade": 0, "shade_reference": 2}
    assert TB.launches == {"bvh_trace": 0, "bvh_trace_reference": 2}


def test_surf_without_device_needs_cuda(monkeypatch):
    """Surf's default device is CUDA; without it the constructor raises
    instead of training on the CPU."""
    from volsurfs_tpu_torch.methods.surf import Surf
    from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hp = HyperParamsSuRF(appearance_predict_sh_coeffs=True)
    with pytest.raises(RuntimeError, match="cuda"):
        Surf(hp, make_bounding_sphere(1.0))


def test_cpu_tensors_take_the_plain_permuto_and_sampler():
    """K6 (forward, and the backward's updates) and K7 on CPU tensors run
    their plain versions."""
    from volsurfs_tpu_torch.models.encodings import PermutoEncoder
    from volsurfs_tpu_torch.ops.occupancy import make_grid

    for counts in (P.launches, SP.launches, S.launches):
        for key in counts:
            counts[key] = 0
    enc = PermutoEncoder()
    feats, dfeats, _ = enc(torch.rand(8, 3) - 0.5, with_grads=True)
    (feats.sum() + dfeats.sum()).backward()
    grid = make_grid(8, 2.0, sphere_roi_radius=1.0)
    rays_o = torch.tensor([[0.0, 0.0, -2.0]])
    z, mask, _, _, _ = SP.occupancy_samples(
        rays_o, torch.tensor([[0.0, 0.0, 1.0]]), torch.ones(1, 1), torch.full((1, 1), 3.0), grid,
        torch.zeros(1, 1), 1e-4, 1, 16, 64, 64)
    assert bool(mask.all()) and z.shape == (1, 16)
    assert P.launches == {"permuto_fwd": 0, "permuto_fwd_reference": 1,
                          "permuto_bwd": 0, "permuto_bwd_reference": 1}
    assert SP.launches == {"occupancy_sampler": 0, "occupancy_sampler_reference": 1,
                           "bg_samples": 0, "bg_samples_reference": 0}
    assert S.launches == {"scatter_add": 0, "scatter_add_reference": 1}


def test_offsets_surfs_without_device_needs_cuda(monkeypatch):
    """OffsetsSurfs' default device is CUDA; without it the constructor
    raises instead of training on the CPU."""
    from volsurfs_tpu_torch.methods.offsets_surfs import OffsetsSurfs
    from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
    from volsurfs_tpu_torch.params.hyper_params import HyperParamsOffsetsSuRFs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        OffsetsSurfs(HyperParamsOffsetsSuRFs(), make_bounding_sphere(1.0))


def test_mesh_stages_and_pipeline_without_device_need_cuda(monkeypatch, tmp_path):
    """The marching, the TSDF fusion and run_pipeline default to CUDA;
    without it each raises instead of running on the CPU."""
    from volsurfs_tpu_torch.baking import marching, tsdf
    from volsurfs_tpu_torch.datasets.mvdataset import MVDataset
    from volsurfs_tpu_torch.params.hyper_params import HyperParamsOffsetsSuRFs
    from volsurfs_tpu_torch.pipeline import run_pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    values = np.linspace(-1.0, 1.0, 64, dtype=np.float32).reshape(4, 4, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        marching.marching_tetrahedra(values, np.zeros(3), np.ones(3))
    with pytest.raises(RuntimeError, match="cuda"):
        marching.extract_mesh_from_fn(lambda p: p[:, 0], 4)
    with pytest.raises(RuntimeError, match="cuda"):
        tsdf.fuse_depths([], [], resolution=4)
    mv = MVDataset("synthetic", "sphere", "", config={"width": 8, "height": 8,
                                                       "nr_train_cameras": 1,
                                                       "nr_test_cameras": 1})
    with pytest.raises(RuntimeError, match="cuda"):
        run_pipeline(mv, str(tmp_path), HyperParamsSuRF(), HyperParamsOffsetsSuRFs(),
                     HyperParamsVolSurfs())
    assert not os.listdir(tmp_path)


def test_cpu_tensors_take_the_plain_volume_rendering_kernels():
    """K8a (combine), K8b (the transmittance scan, forward and backward),
    K8c (importance sampling) and K8d (the nerf importance round) on CPU
    tensors run their plain versions."""
    from volsurfs_tpu_torch.ops import samples as TS
    from volsurfs_tpu_torch.ops import volume_rendering as VR

    for counts in (TS.launches, VR.launches):
        for key in counts:
            counts[key] = 0
    z = torch.tensor([[1.0, 1.5, 2.0, 1e10]])
    mask = torch.tensor([[True, True, True, False]])
    one = torch.ones(1, 1)
    a = TS.RaySamples(z=z, dt=torch.zeros_like(z), mask=mask, rays_o=torch.zeros(1, 3),
                      rays_d=torch.tensor([[0.0, 0.0, 1.0]]), t_near=one, t_far=3 * one,
                      max_dt=0.5 * one)
    a = TS.update_dt(a)
    merged, _ = TS.combine(a, a, 1e-4)
    assert merged.mask.sum() == 3 and merged.z.shape == (1, 8)
    alpha = torch.full((1, 4), 0.5, requires_grad=True)
    w, _, _ = VR.neus_weights(a, alpha)
    w.sum().backward()
    assert alpha.grad is not None
    imp = VR.neus_importance(a, torch.stack([2.0 - z, 1.8 - z], dim=-1), 20.0, 4)
    assert bool(imp.mask.all()) and imp.z.shape == (1, 4)
    imp = VR.nerf_importance(a, torch.full((1, 4), 2.0), 4)
    assert bool(imp.mask.all()) and imp.z.shape == (1, 4)
    assert TS.launches == {"combine_samples": 0, "combine_samples_reference": 1}
    # the transmittance's plain scan: the weights, K8c's two surfaces, K8d's
    assert VR.launches == {"neus_transmittance_fwd": 0, "neus_transmittance_bwd": 0,
                           "neus_transmittance_reference": 4, "neus_importance": 0,
                           "neus_importance_reference": 1, "nerf_importance": 0,
                           "nerf_importance_reference": 1}


def test_cpu_tensors_take_the_plain_background_samples_and_march_step():
    """K10 (the background's samples) and K9 (a sphere-trace step) on CPU
    tensors run their plain versions."""
    from volsurfs_tpu_torch.ops import sphere_tracing as ST
    from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere

    for counts in (SP.launches, ST.launches):
        for key in counts:
            counts[key] = 0
    rays_o = torch.tensor([[0.0, 0.0, -2.0], [0.0, 3.0, -2.0]])
    rays_d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    cpos, dirs, c, z = SP.contracted_bg_samples(rays_o, rays_d, torch.tensor([[3.0], [0.0]]), 8)
    assert cpos.shape == (2, 8, 3) and bool((z[:, -1] == 100.0).all())
    assert float(cpos.norm(dim=-1).max()) <= 1.0
    trace = ST.sphere_trace(lambda p: torch.linalg.norm(p, dim=-1, keepdim=True) - 0.5,
                            rays_o, rays_d, make_bounding_sphere(1.0), nr_sphere_traces=16)
    assert trace["is_hit"].tolist() == [True, False]
    assert abs(float(trace["z"][0, 0]) - 1.5) < 1e-3
    assert SP.launches == {"occupancy_sampler": 0, "occupancy_sampler_reference": 0,
                           "bg_samples": 0, "bg_samples_reference": 1}
    assert ST.launches == {"sphere_trace_step": 0,
                           "sphere_trace_step_reference": trace["steps"]}
