"""Multi-view datasets (the ``synthetic`` path of
volsurfs_tpu/datasets/mvdataset.py; its Blender, Shelly and DTU loaders are
not ported yet).

``MVDataset("synthetic", scene, path, splits, config)`` renders the
procedural scene of ``synthetic.py``: the ``train`` split from seed 0 and
the ``test`` split from seed 1, cameras at radius 2 around a sphere of
radius 0.5.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from volsurfs_tpu_torch.datasets import synthetic


@dataclasses.dataclass
class Split:
    cameras: list
    rgbs: np.ndarray  # [N, H, W, 3] float32
    masks: np.ndarray  # [N, H, W, 1] float32


class MVDataset:
    """dataset_name "synthetic" (others raise NotImplementedError); splits
    dict of Split."""

    def __init__(
        self,
        dataset_name: str,
        scene_name: str,
        datasets_path: str,
        splits=("train", "test"),
        config: dict | None = None,
    ):
        config = config or {}
        self.dataset_name = dataset_name
        self.scene_name = scene_name
        self.splits: dict[str, Split] = {}
        self.scene_radius = float(config.get("scene_radius", 1.0))
        self.init_sphere_scale = float(config.get("init_sphere_scale", 0.3))
        self.bg_color = config.get("bg_color", None)

        if dataset_name != "synthetic":
            raise NotImplementedError(
                f"dataset {dataset_name} is not ported to torch yet (only synthetic)")
        w = int(config.get("width", 64))
        h = int(config.get("height", 64))
        n_train = int(config.get("nr_train_cameras", 24))
        n_test = int(config.get("nr_test_cameras", 4))
        for split, n, seed in (("train", n_train, 0), ("test", n_test, 1)):
            if split not in splits:
                continue
            cams, rgbs, masks = synthetic.make_synthetic_split(
                n, w, h, cam_radius=2.0, sphere_radius=0.5, seed=seed, scene=scene_name,
            )
            self.splits[split] = Split(cams, rgbs, masks)
        self.bg_color = self.bg_color or "white"

    def __getitem__(self, split: str) -> Split:
        return self.splits[split]

    def has_masks(self) -> bool:
        return True
