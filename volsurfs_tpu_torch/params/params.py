"""Parameter classes for paths / training / data configuration (a copy of
volsurfs_tpu/params/params.py, which cannot be imported without JAX).

The three-tier config mechanism: hjson files (``config/*.cfg``) parsed into
typed parameter objects, per-dataset + per-scene merge for data params, and
the run-directory lifecycle ``init_run``.
"""

from __future__ import annotations

import os
import shutil
import time

from volsurfs_tpu_torch.params import hjson


class Params:
    """Base: loads an hjson file into self.cfg (reference params/params.py:17-48)."""

    def __init__(self, cfg_path: str | None = None):
        self.cfg = hjson.load(cfg_path) if cfg_path else {}


class PathsParams(Params):
    """datasets/runs roots (reference params/paths_params.py, config/paths_config.cfg)."""

    def __init__(self, cfg_path: str | None = None, datasets: str | None = None,
                 runs: str | None = None):
        super().__init__(cfg_path)
        paths = self.cfg.get("paths", {})
        self.datasets_path = datasets or paths.get("datasets", "./data")
        self.runs_path = runs or paths.get("runs", "./runs")


class TrainParams(Params):
    """Logging/eval cadences per method (reference params/train_params.py:36-72,
    config/train_config.cfg)."""

    def __init__(self, method_name: str, cfg_path: str | None = None):
        super().__init__(cfg_path)
        train_cfg = self.cfg.get("train", {})
        self.with_wandb = bool(train_cfg.get("with_wandb", 0))
        self.save_checkpoints = bool(train_cfg.get("save_checkpoints", 1))
        self.compute_test_loss = bool(train_cfg.get("compute_test_loss", 1))
        self.eval_test = bool(train_cfg.get("eval_test", 1))
        self.eval_train = bool(train_cfg.get("eval_train", 0))
        method_cfg = self.cfg.get(method_name, {})
        self.checkpoint_freq = int(method_cfg.get("checkpoint_freq", 999999))
        self.compute_test_loss_freq = int(
            method_cfg.get("compute_test_loss_freq", 1000)
        )
        self.eval_test_freq = int(method_cfg.get("eval_test_freq", 999999))
        self.eval_train_freq = int(method_cfg.get("eval_train_freq", 999999))
        self.render_freq = int(method_cfg.get("render_freq", 10000))


class DataParams(Params):
    """Per-dataset + per-scene config merge (reference params/data_params.py:5-44)."""

    def __init__(self, dataset_name: str, scene_name: str, cfg_path: str | None = None):
        super().__init__(cfg_path)
        dataset_cfg = dict(self.cfg.get(dataset_name, {}))
        scenes = dataset_cfg.pop("scenes", {})
        scene_cfg = scenes.get(scene_name, {})
        merged = dict(dataset_cfg)
        merged.update(scene_cfg)
        self.dict = merged
        self.bg_color = merged.get("bg_color", None)
        self.subsample_factor = int(merged.get("subsample_factor", 1))
        self.test_skip = int(merged.get("test_skip", 1))
        self.init_sphere_scale = float(merged.get("init_sphere_scale", 0.3))
        self.scene_radius_mult = float(merged.get("scene_radius_mult", 1.0))


def init_run(
    runs_path: str,
    method_name: str,
    exp_name: str,
    scene_name: str,
    run_id: str | None = None,
    continue_training: bool = False,
    config_files: dict | None = None,
):
    """Run-directory lifecycle (reference utils/volsurfs_utils.py:33-150):
    creates runs/<method>/<exp>/<scene>/<run_id>/ with a config/ copy so the
    configs are part of the checkpoint; resuming re-uses the directory.

    Returns (run_dir, run_id).
    """
    if run_id is None:
        if continue_training:
            base = os.path.join(runs_path, method_name, exp_name, scene_name)
            candidates = sorted(os.listdir(base)) if os.path.isdir(base) else []
            if not candidates:
                raise FileNotFoundError(f"no runs to continue under {base}")
            run_id = candidates[-1]
        else:
            run_id = time.strftime("%Y-%m-%d-%H%M%S")
    run_dir = os.path.join(runs_path, method_name, exp_name, scene_name, run_id)
    os.makedirs(run_dir, exist_ok=True)
    cfg_dir = os.path.join(run_dir, "config")
    os.makedirs(cfg_dir, exist_ok=True)
    for name, path in (config_files or {}).items():
        if path and os.path.exists(path):
            shutil.copy(path, os.path.join(cfg_dir, f"{name}.cfg"))
    return run_dir, run_id
