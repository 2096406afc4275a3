"""Hyper-parameters, loadable from the hjson configs under ``config/``.

Counterpart of volsurfs_tpu/params/hyper_params.py, with the base class and
the surf, nerf, offsets_surfs and volsurfs methods' classes, including their
validation and coupling rules. Defaults are the
reference's defaults; any field present under ``hyper_params`` in a config
file overrides the default.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from volsurfs_tpu_torch.params import hjson


@dataclasses.dataclass
class HyperParams:
    # lr schedule
    lr: float = 1e-3
    lr_milestones: List[int] = dataclasses.field(
        default_factory=lambda: [100000, 150000, 180000, 190000]
    )
    training_end_iter: int = 200000
    nr_warmup_iters: int = 3000

    # appearance
    geom_feat_size: int = 0
    rgb_mlp_layers_dims: List[int] = dataclasses.field(
        default_factory=lambda: [128, 128, 64]
    )
    appearance_predict_sh_coeffs: bool = False
    sh_degree: int = 3
    rgb_mlp_output_dims: int = 3
    rgb_view_dep: bool = True
    rgb_normal_dep: bool = True
    rgb_geom_feat_dep: bool = True
    rgb_use_lipshitz_mlp: bool = False
    rgb_pos_encoder_type: str = "permutohash"
    rgb_dir_encoder_type: str = "spherical_harmonics"

    # background
    bg_pos_encoder_type: str = "permutohash"
    bg_dir_encoder_type: str = "spherical_harmonics"

    use_color_calibration: bool = False

    # coarse to fine
    rgb_nr_iters_for_c2f: int = 0
    bg_nr_iters_for_c2f: int = 0

    # masks / losses
    is_training_masked: bool = False
    is_testing_masked: bool = False
    mask_weight: float = 0.0

    use_occupancy_grid: bool = True
    # clip each ray's marched interval to its occupied t-range before
    # placing samples (reference OccupancyGridGPU.cuh:318-396
    # get_rays_t_near_t_far); improves effective sampling resolution
    clip_rays_to_occupancy: bool = True
    use_grad_scaler: bool = False

    # sampling
    training_rays_batch_size: int = 512
    test_rays_batch_size: int = 512
    nr_training_rays_per_pixel: int = 1
    nr_test_rays_per_pixel: int = 1
    jitter_training_rays: bool = True
    jitter_test_rays: bool = False
    is_nr_training_rays_dynamic: bool = True
    target_nr_of_training_samples: int = 512 * (64 + 16 + 16)
    do_importance_sampling: bool = False
    max_nr_imp_samples_per_ray: int = 32
    min_dist_between_samples: float = 1e-4
    min_nr_samples_per_ray: int = 1
    max_nr_samples_per_ray: int = 64
    nr_samples_bg: int = 32

    def __post_init__(self):
        # coupling rules (reference hyper_params.py:172-192)
        if self.do_importance_sampling and self.min_nr_samples_per_ray < 3:
            self.min_nr_samples_per_ray = 3
        if self.nr_test_rays_per_pixel > 1:
            self.jitter_test_rays = True
        if self.nr_training_rays_per_pixel > 1:
            self.jitter_training_rays = True
        if self.rgb_geom_feat_dep and self.geom_feat_size == 0:
            self.rgb_geom_feat_dep = False
        if self.test_rays_batch_size < 1:
            self.test_rays_batch_size = None

    @classmethod
    def from_cfg(cls, cfg_path: str) -> "HyperParams":
        cfg = hjson.load(cfg_path)
        hp_cfg = cfg.get("hyper_params", {})
        field_names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for key, value in hp_cfg.items():
            if key in field_names:
                kwargs[key] = value
        obj = cls(**kwargs)
        obj.cfg = cfg
        return obj


@dataclasses.dataclass
class HyperParamsSuRF(HyperParams):
    # geometry (reference hyper_params.py:195-264)
    sdf_mlp_layers_dims: List[int] = dataclasses.field(default_factory=lambda: [32, 32])
    sdf_mlp_output_dims: int = 1
    sdf_encoding_type: str = "permutohash"
    # "autodiff": the encoder's analytic Jacobian carried through the MLP;
    # "finite_diff": the reference's 4-point forward difference
    sdf_grads_mode: str = "autodiff"
    init_phase_end_iter: int = 4000
    sdf_nr_iters_for_c2f: int = 10000
    first_phase_variance_start_value: float = 0.3
    first_phase_variance_end_value: float = 0.8
    first_phase_end_iter: int = 35000
    reduce_curv_start_iter: Optional[int] = None
    reduce_curv_end_iter: Optional[int] = None
    eikonal_weight: float = 0.0
    curvature_weight: float = 0.0
    lipshitz_weight: float = 0.0
    offsurface_weight: float = 0.0

    def __post_init__(self):
        super().__post_init__()
        assert self.sdf_grads_mode in ("autodiff", "finite_diff"), (
            f"sdf_grads_mode must be 'autodiff' or 'finite_diff', got {self.sdf_grads_mode!r}"
        )


@dataclasses.dataclass
class HyperParamsOffsetsSuRFs(HyperParamsSuRF):
    # surfaces (reference hyper_params.py:267-348)
    nr_inner_surfs: int = 1
    nr_outer_surfs: int = 1
    delta_surfs_multiplier: float = 1.0
    color_init_phase_end_iter: int = 6000
    are_surfs_colors_indep: bool = False
    are_surfs_transparency_indep: bool = False
    is_inner_surf_solid: bool = False
    transp_view_dep: bool = True
    transp_normal_dep: bool = True
    transp_geom_feat_dep: bool = True
    offsets_weight: float = 0.0
    support_surfs_eikonal_weight: float = 0.0
    with_alpha_decay: bool = True

    def __post_init__(self):
        super().__post_init__()
        if self.transp_geom_feat_dep and self.geom_feat_size == 0:
            self.transp_geom_feat_dep = False


@dataclasses.dataclass
class HyperParamsNeRF(HyperParams):
    # density (reference hyper_params.py:351-378)
    density_mlp_layers_dims: List[int] = dataclasses.field(
        default_factory=lambda: [32, 32]
    )
    density_mlp_output_dims: int = 1
    density_encoding_type: str = "permutohash"
    density_nr_iters_for_c2f: int = 10000
    sparsity_weight: float = 0.0


@dataclasses.dataclass
class HyperParamsVolSurfs(HyperParams):
    # mesh-shell appearance (reference hyper_params.py:381-479)
    meshes_indices: Optional[List[int]] = None
    are_volsurfs_colors_indep: bool = True
    are_volsurfs_alphas_indep: bool = True
    is_inner_mesh_solid: bool = True
    using_neural_textures: bool = False
    using_neural_textures_anchor: bool = False
    using_neural_textures_lerp: bool = False
    using_sh_quantization: bool = False
    using_sh_squeezing: bool = False
    transp_view_dep: bool = True
    transp_normal_dep: bool = True
    sh_range: List[float] = dataclasses.field(
        default_factory=lambda: [1.0, 5.0, 10.0, 20.0]
    )
    textures_res: List[int] = dataclasses.field(
        default_factory=lambda: [2048, 1024, 512, 256]
    )
    with_alpha_decay: bool = True

    def __post_init__(self):
        super().__post_init__()
        if self.using_neural_textures:
            # reference hyper_params.py:453-471 validation
            assert self.appearance_predict_sh_coeffs, (
                "neural textures require appearance_predict_sh_coeffs"
            )
            assert self.rgb_view_dep, "neural textures require rgb_view_dep"
            assert not (self.transp_normal_dep or self.rgb_normal_dep), (
                "neural textures cannot be conditioned on normals"
            )
        assert not self.rgb_geom_feat_dep and self.geom_feat_size == 0, (
            "appearance on meshes can't be conditioned on geometry features"
        )


def get_method_hyper_params(method_name: str, cfg_path: str):
    """Hyper-parameters of a method from a config file."""
    cls = {"surf": HyperParamsSuRF, "nerf": HyperParamsNeRF,
           "offsets_surfs": HyperParamsOffsetsSuRFs,
           "volsurfs": HyperParamsVolSurfs}.get(method_name)
    if cls is None:
        raise ValueError(f"unknown method name {method_name}")
    return cls.from_cfg(cfg_path)
