"""The configuration of the volsurfs stage's tests (no JAX, so that the
card's tests can take it too)."""

# tests/test_volsurfs_e2e.py's configuration: 2 shells, sh_degree 1, 64^2
# textures, 128 rays a step, 30 steps, a white background
HP = dict(
    is_nr_training_rays_dynamic=False,
    training_rays_batch_size=128,
    training_end_iter=30,
    nr_warmup_iters=4,
    lr=5e-3,
    lr_milestones=[10000],
    using_neural_textures=True,
    using_neural_textures_lerp=True,
    using_sh_squeezing=True,
    using_sh_quantization=True,
    appearance_predict_sh_coeffs=True,
    sh_degree=1,
    sh_range=[15, 15, 15, 15],
    textures_res=[64, 64, 64, 64],
    rgb_view_dep=True,
    rgb_normal_dep=False,
    transp_normal_dep=False,
    rgb_geom_feat_dep=False,
    geom_feat_size=0,
    is_inner_mesh_solid=True,
    nr_samples_bg=8,
    use_occupancy_grid=False,
)
DATA = {"width": 32, "height": 32, "nr_train_cameras": 6, "nr_test_cameras": 2}
