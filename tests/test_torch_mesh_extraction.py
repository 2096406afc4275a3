"""The baker's mesh stages in the port against volsurfs_tpu's, on the CPU:
``extract_meshes_from_offsets_surfs`` on parameters carried over by
``convert.py`` (the pair of tests/_torch_offsets_pair.py: small widths, the
full 24-level tables, K = 5 surfaces; JAX op by op) gives grid values
within 1e-5 of JAX's and, given JAX's grid, JAX's meshes; then the baker
CLI's mesh flags on tiny CPU runs (--device cpu)."""

import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import torch

from volsurfs_tpu.baking import baker as JB
from volsurfs_tpu_torch.baking import baker
from volsurfs_tpu_torch.baking import mesh_io
from volsurfs_tpu_torch.baking.marching import grid_points
from volsurfs_tpu_torch.methods.surf import Surf
from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
from volsurfs_tpu_torch.params.hyper_params import HyperParamsSuRF
from volsurfs_tpu_torch.training import trainer as TT

from _torch_offsets_pair import DATA_ITER, make_pair

torch.set_num_threads(2)

RES = 24
GRID_TOL = dict(rtol=1e-5, atol=1e-5)


def test_extract_meshes_from_offsets_surfs_matches_jax(monkeypatch):
    jmethod, params, method = make_pair()
    assert method.iter_nr == DATA_ITER
    state = SimpleNamespace(params=params, iter_nr=DATA_ITER)
    pts = grid_points(RES, float(method.radius), device="cpu").numpy()
    with jax.disable_jit():
        ref_meshes = JB.extract_meshes_from_offsets_surfs(jmethod, state, resolution=RES)
        ref_values = np.asarray(jmethod._sdfs_fn(params, pts, DATA_ITER)[0][..., 0])
    ref_values = ref_values.reshape(RES, RES, RES, -1)
    got_meshes = baker.extract_meshes_from_offsets_surfs(method, resolution=RES)
    got_values = method._sdfs(torch.from_numpy(pts), DATA_ITER)[0][..., 0].detach().numpy()
    np.testing.assert_allclose(got_values.reshape(ref_values.shape), ref_values, **GRID_TOL)
    assert len(got_meshes) == len(ref_meshes) == method.nr_surfs == 5
    assert sum(len(f) for _, f in ref_meshes) > 0

    # given JAX's grid, the port's extraction gives JAX's meshes
    monkeypatch.setattr(baker, "evaluate_grid", lambda *a, **k: torch.from_numpy(ref_values.copy()))
    for (gv, gf), (rv, rf) in zip(baker.extract_meshes_from_offsets_surfs(method, RES),
                                  ref_meshes):
        np.testing.assert_array_equal(gf, rf)
        np.testing.assert_allclose(gv, rv, rtol=0, atol=1e-6)


WIDTHS = {"sdf_mlp_layers_dims": [16, 16], "geom_feat_size": 8,
          "rgb_mlp_layers_dims": [32, 32], "sh_degree": 1}


def _cfg(tmp_path, hp):
    cfg = tmp_path / "cfg"
    cfg.mkdir(exist_ok=True)
    path = cfg / f"exp_{len(os.listdir(cfg))}.cfg"
    path.write_text("hyper_params: {\n" + "\n".join(f"    {k}: {json.dumps(v)}"
                                                    for k, v in hp.items()) + "\n}\n")
    data = cfg / "data.cfg"
    data.write_text("synthetic: {\n    bg_color: \"white\"\n    width: 16\n    height: 16\n"
                    "    nr_train_cameras: 2\n    nr_test_cameras: 1\n}\n")
    return str(path), str(data)


def test_baker_mesh_flags_on_cpu_runs(tmp_path, capsys):
    """An offsets_surfs run from a surf SDF (2 offsets-init steps):
    --extract_meshes writes every surface's raw mesh, --simplify_meshes
    --compute_meshes_xatlas the non-empty ones with uvs; a surf run (2
    sphere-init steps): --extract_meshes its zero level set and
    --extract_bg_mesh the TSDF fusion of its depth renders."""
    surf = Surf(HyperParamsSuRF(**WIDTHS, use_occupancy_grid=False), make_bounding_sphere(1.0),
                bg_color="white", init_sphere_radius=0.5, device="cpu", seed=5)
    # a sphere of radius 0.5 in the SDF's output bias, the rest small noise
    with torch.no_grad():
        surf.models["sdf"].encoder.table.uniform_(-1e-3, 1e-3)
    models = tmp_path / "surf_models"
    models.mkdir()
    torch.save(surf.models["sdf"].state_dict(), models / "sdf.pt")
    runs = str(tmp_path / "runs")
    hp = {**WIDTHS, "init_phase_end_iter": 4, "nr_inner_surfs": 2, "nr_outer_surfs": 0,
          "training_rays_batch_size": 32, "max_nr_samples_per_ray": 12,
          "max_nr_imp_samples_per_ray": 8, "do_importance_sampling": 1}
    exp, data = _cfg(tmp_path, hp)
    common = ["--runs_path", runs, "--run_id", "r", "--data_config", data, "--device", "cpu",
              "--occupancy_res", "16"]
    TT.main(["--method", "offsets_surfs", "--exp_config", exp, "--models_path", str(models),
             "--train_iters", "2", *common])
    baker.main(["--method", "offsets_surfs", "--extract_meshes", "--simplify_meshes",
                "--compute_meshes_xatlas", "--extract_bg_mesh", "--extraction_res", "24",
                "--simplify_ratio", "0.3", *common])
    run_dir = os.path.join(runs, "offsets_surfs", "default", "sphere", "r")
    raw = [mesh_io.load_obj(os.path.join(run_dir, "meshes_raw", f"{i}.obj")) for i in range(3)]
    assert sorted(os.listdir(os.path.join(run_dir, "meshes_raw"))) == ["0.obj", "1.obj", "2.obj"]
    kept = sorted(os.listdir(os.path.join(run_dir, "meshes")))
    assert kept == [f"{i}.obj" for i in range(sum(len(f) >= 4 for _, f, _ in raw))]
    for name in kept:
        v, f, uv = mesh_io.load_obj(os.path.join(run_dir, "meshes", name))
        assert uv is not None and uv.shape == (len(v), 2) and len(f) > 0
    # offsets_surfs renders no depth: no background mesh, as in JAX
    assert not os.path.exists(os.path.join(run_dir, "bg_mesh.obj"))

    surf_hp = {**WIDTHS, "init_phase_end_iter": 4, "training_rays_batch_size": 32,
               "max_nr_samples_per_ray": 12, "max_nr_imp_samples_per_ray": 8}
    exp, data = _cfg(tmp_path, surf_hp)
    TT.main(["--method", "surf", "--exp_config", exp, "--train_iters", "2", *common])
    capsys.readouterr()
    baker.main(["--method", "surf", "--extract_meshes", "--extract_bg_mesh",
                "--extraction_res", "24", *common])
    out = capsys.readouterr().out
    run_dir = os.path.join(runs, "surf", "default", "sphere", "r")
    assert "extracted 1 meshes" in out
    assert os.listdir(os.path.join(run_dir, "meshes_raw")) == ["0.obj"]
    v, f, _ = mesh_io.load_obj(os.path.join(run_dir, "bg_mesh.obj"))
    assert f"bg mesh: {len(v)} verts" in out

