"""The configuration of the pipeline tests (no JAX, so that the card's
tests take it too): tests/test_pipeline_e2e.py's sizes with the
permutohedral encoder in place of gridhash and a few steps a stage. So
that a few steps leave more than one level set inside the grid, the surf
stage fits a larger initial sphere (INIT_SPHERE_RADIUS) at a higher
learning rate and the offsets-init phase runs at a higher one still; both
init phases take INIT_POINTS random points a step (of 30,000)."""

from volsurfs_tpu_torch.params.hyper_params import (
    HyperParamsOffsetsSuRFs,
    HyperParamsSuRF,
    HyperParamsVolSurfs,
)

COMMON = dict(is_nr_training_rays_dynamic=False, clip_rays_to_occupancy=False,
              training_rays_batch_size=96, max_nr_samples_per_ray=16,
              max_nr_imp_samples_per_ray=8, do_importance_sampling=True, nr_warmup_iters=1,
              lr_milestones=[10000], geom_feat_size=16, nr_samples_bg=8,
              sdf_encoding_type="permutohash", rgb_pos_encoder_type="permutohash")
STEPS = {"surf": 30, "offsets_surfs": 18, "volsurfs": 4}
INIT_POINTS = 4000


def hps():
    """(surf, offsets_surfs, volsurfs) hyper-parameters."""
    surf = HyperParamsSuRF(init_phase_end_iter=60, first_phase_end_iter=400,
                           training_end_iter=STEPS["surf"], lr=1e-2, eikonal_weight=0.04,
                           offsurface_weight=1e-4, sdf_nr_iters_for_c2f=0,
                           curvature_weight=0.0, **COMMON)
    offsets = HyperParamsOffsetsSuRFs(init_phase_end_iter=16, color_init_phase_end_iter=17,
                                      first_phase_end_iter=160,
                                      training_end_iter=STEPS["offsets_surfs"], lr=5e-2,
                                      nr_inner_surfs=1, nr_outer_surfs=1,
                                      eikonal_weight=0.04, support_surfs_eikonal_weight=0.04,
                                      offsurface_weight=1e-4, sdf_nr_iters_for_c2f=0,
                                      curvature_weight=0.0, **COMMON)
    volsurfs = HyperParamsVolSurfs(
        is_nr_training_rays_dynamic=False, training_rays_batch_size=128,
        training_end_iter=STEPS["volsurfs"], nr_warmup_iters=5, lr=5e-3, lr_milestones=[10000],
        using_neural_textures=True, using_neural_textures_lerp=True, using_sh_squeezing=True,
        appearance_predict_sh_coeffs=True, sh_degree=1, sh_range=[8, 8, 8, 8],
        textures_res=[64, 64, 64, 64], rgb_normal_dep=False, transp_normal_dep=False,
        rgb_geom_feat_dep=False, geom_feat_size=0, is_inner_mesh_solid=True,
        use_occupancy_grid=False)
    return surf, offsets, volsurfs


DATA = {"width": 32, "height": 32, "nr_train_cameras": 8, "nr_test_cameras": 2}
INIT_SPHERE_RADIUS = 0.75
PIPELINE_KWARGS = dict(occupancy_res=24, mesh_extraction_res=32, simplify_ratio=0.3,
                       init_sphere_radius=INIT_SPHERE_RADIUS)
