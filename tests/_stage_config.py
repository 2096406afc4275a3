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

# tests/test_surf_e2e.py's configuration with the permutohedral encoder in
# place of gridhash for both fields (the port has only permutohash): 96 rays
# a step, 16 + 8 samples a ray, 60 sphere-init steps, 220 steps, the RGB
# colour field, a white background, an occupancy grid of 24^3 voxels
SURF_HP = dict(
    is_nr_training_rays_dynamic=False,
    clip_rays_to_occupancy=False,
    training_rays_batch_size=96,
    max_nr_samples_per_ray=16,
    max_nr_imp_samples_per_ray=8,
    do_importance_sampling=True,
    init_phase_end_iter=60,
    first_phase_end_iter=400,
    training_end_iter=220,
    nr_warmup_iters=10,
    lr=3e-3,
    lr_milestones=[10000],
    eikonal_weight=0.04,
    offsurface_weight=1e-4,
    curvature_weight=0.0,
    geom_feat_size=16,
    sdf_nr_iters_for_c2f=0,
    sdf_encoding_type="permutohash",
    rgb_pos_encoder_type="permutohash",
    nr_samples_bg=8,
)
SURF_DATA = {"width": 32, "height": 32, "nr_train_cameras": 8, "nr_test_cameras": 2}
SURF_OCCUPANCY_RES = 24
SURF_INIT_SPHERE_RADIUS = 0.4

# tests/test_nerf_e2e.py's configuration with the permutohedral encoder in
# place of gridhash for both fields, cut to fit the CPU: 64 rays a step,
# 12 + 6 samples a ray, 250 steps; lr 3e-3 after a 100-step warmup and the
# density's coarse-to-fine over 150 steps (at that test's lr 5e-3 and no
# warmup both packages' density fields collapse to empty in ~20 steps and
# render the white background alone, 10.77 dB); the sparsity term at
# base.cfg's weight (its gate, past step 5,000, stays shut), a white
# background, an occupancy grid of 24^3 voxels
NERF_HP = dict(
    is_nr_training_rays_dynamic=False,
    training_rays_batch_size=64,
    max_nr_samples_per_ray=12,
    max_nr_imp_samples_per_ray=6,
    do_importance_sampling=True,
    training_end_iter=250,
    nr_warmup_iters=100,
    lr=3e-3,
    lr_milestones=[10000],
    sparsity_weight=1e-4,
    geom_feat_size=16,
    density_nr_iters_for_c2f=150,
    density_encoding_type="permutohash",
    rgb_pos_encoder_type="permutohash",
    rgb_normal_dep=False,
    nr_samples_bg=8,
)
NERF_DATA = SURF_DATA
NERF_OCCUPANCY_RES = 24
