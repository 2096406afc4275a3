"""The training loop (counterpart of volsurfs_tpu/training/trainer.py).

    python -m volsurfs_tpu_torch.training.trainer --method volsurfs \\
        --meshes_path DIR [--dataset synthetic --scene sphere] [--device cuda]

The port's methods are stateful (each holds its modules, its optimizer and
``iter_nr``), so ``Trainer.train`` advances the method in place and returns
it; it takes no JAX-style ``TrainState``. Ray batches are drawn on the
method's device from ``self.generator``, a ``torch.Generator`` seeded with
``seed + 1234`` (JAX's batch key); its state goes into every checkpoint.
Losses stay on the device: the loop reads them every ``log_every`` steps,
and the callbacks at their own cadences.

All four methods of the JAX package are ported: ``surf``, ``nerf``,
``offsets_surfs`` and ``volsurfs``. A method with an occupancy grid (surf,
nerf, offsets_surfs) has it refreshed every
``update_occupancy_every`` steps, before the step, as in JAX. As in JAX, the
dynamic ray count acts only when the losses carry ``nr_samples_total``
(surf's, nerf's and offsets_surfs' data steps do, volsurfs' do not). The CLI's
``--models_path`` takes a previous stage's models directory: a surf run's
``sdf.pt`` goes into offsets_surfs' shared encoder and main head
(``OffsetsSurfs.load_main_sdf``), and its ``bg.pt`` (the trained
background) into any method that has one, as JAX's ``bg.msgpack``. Not ported: the TPU compile-retry wrapper (nothing is compiled here),
data parallelism over a device mesh (``--data_parallel``, Queue 1 item 9),
the distillation mix and the profiler hook.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from volsurfs_tpu_torch.datasets.cameras import get_camera_rays
from volsurfs_tpu_torch.datasets.mvdataset import MVDataset
from volsurfs_tpu_torch.datasets.tensor_reel import get_next_rays_batch, make_tensor_reel
from volsurfs_tpu_torch.methods.base import render_frame_chunked
from volsurfs_tpu_torch.methods.volsurfs import resolve_device
from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
from volsurfs_tpu_torch.params.hyper_params import get_method_hyper_params
from volsurfs_tpu_torch.training import checkpoints
from volsurfs_tpu_torch.utils.evaluation import PerSceneEvaluator

METHODS = ("surf", "nerf", "offsets_surfs", "volsurfs")


def make_method(method_name, hp, bounding_primitive, bg_color, seed: int = 0,
                device="cuda", occupancy_res: int = 256, **method_kwargs):
    if method_name not in METHODS:
        raise ValueError(f"unknown method {method_name}")
    if method_name == "surf":
        from volsurfs_tpu_torch.methods.surf import Surf

        return Surf(hp, bounding_primitive, bg_color=bg_color, occupancy_res=occupancy_res,
                    device=device, seed=seed, **method_kwargs)
    if method_name == "nerf":
        from volsurfs_tpu_torch.methods.nerf import NeRF

        return NeRF(hp, bounding_primitive, bg_color=bg_color, occupancy_res=occupancy_res,
                    device=device, seed=seed, **method_kwargs)
    if method_name == "offsets_surfs":
        from volsurfs_tpu_torch.methods.offsets_surfs import OffsetsSurfs

        return OffsetsSurfs(hp, bounding_primitive, bg_color=bg_color,
                            occupancy_res=occupancy_res, device=device, seed=seed,
                            **method_kwargs)
    from volsurfs_tpu_torch.methods.volsurfs import VolSurfs

    return VolSurfs(hp, bg_color=bg_color, bounding_primitive=bounding_primitive,
                    device=device, seed=seed, **method_kwargs)


class Trainer:
    def __init__(
        self,
        method,
        mv_data: MVDataset,
        run_dir: str,
        update_occupancy_every: int = 50,
        log_every: int = 100,
        seed: int = 0,
        train_params=None,
        callbacks=None,
    ):
        self.device = resolve_device(method.device)
        self.method = method
        self.mv_data = mv_data
        self.run_dir = run_dir
        self.update_occupancy_every = update_occupancy_every
        self.log_every = log_every
        self.train_params = train_params
        self.callbacks = callbacks
        os.makedirs(run_dir, exist_ok=True)

        train_split = mv_data["train"]
        self.reel = make_tensor_reel(train_split.cameras, train_split.rgbs, train_split.masks,
                                     device=self.device)
        if "test" in mv_data.splits:
            test_split = mv_data["test"]
            self.test_reel = make_tensor_reel(test_split.cameras, test_split.rgbs,
                                              test_split.masks, device=self.device)
        else:
            self.test_reel = None
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1234)
        # the ray count's power-of-2 buckets, as JAX's
        self._rays_bucket = int(method.hp.training_rays_batch_size)
        self._min_bucket = max(32, self._rays_bucket // 8)
        self._max_bucket = self._rays_bucket * 8
        self.loss_history = []

    @property
    def ckpt_dir(self) -> str:
        return os.path.join(self.run_dir, "checkpoints")

    def train_iteration(self) -> dict:
        """One step: a ray batch from the train reel, then the method's
        train step. Returns its losses (0-d tensors on the device)."""
        hp = self.method.hp
        n = hp.nr_training_rays_per_pixel
        batch = get_next_rays_batch(self.reel, self.generator, self._rays_bucket * n,
                                    jitter_pixels=hp.jitter_training_rays, nr_rays_per_pixel=n)
        return self.method.train_step(batch)

    def _adjust_ray_bucket(self, losses, it: int):
        """Pick the power-of-2 ray bucket whose sample count is closest to
        target_nr_of_training_samples, every 10 iterations, when the losses
        report ``nr_samples_total``."""
        hp = self.method.hp
        if not hp.is_nr_training_rays_dynamic or "nr_samples_total" not in losses:
            return
        if it % 10 != 0:
            return
        actual = float(losses["nr_samples_total"])
        if actual <= 0:
            return
        target = float(hp.target_nr_of_training_samples)
        ideal = self._rays_bucket * target / actual
        bucket = 2 ** int(round(np.log2(max(ideal, 1.0))))
        self._rays_bucket = int(np.clip(bucket, self._min_bucket, self._max_bucket))

    def estimate_test_loss(self):
        """RGB L1 on a random batch of test rays (no jitter), or None
        without a test split."""
        if self.test_reel is None:
            return None
        batch = get_next_rays_batch(self.test_reel, self.generator,
                                    self.method.hp.training_rays_batch_size, jitter_pixels=False)
        out = self.method.make_render_fn()(batch["rays_o"], batch["rays_d"])
        return float(torch.mean(torch.abs(out["rgb"] - batch["gt_rgb"])))

    def save_checkpoint(self) -> str:
        return checkpoints.save_checkpoint(self.ckpt_dir, self.method, self.generator)

    def load_checkpoint(self, iter_nr: int | None = None):
        return checkpoints.load_checkpoint(self.ckpt_dir, self.method, self.generator, iter_nr)

    def train(self, end_iter: int | None = None, callback=None):
        """Train from the method's iter_nr to end_iter (hp.training_end_iter
        if None), with the cadenced side work of ``train_params``; saves the
        final checkpoint. callback(iter_nr, method, losses) runs after each
        step. Returns the method."""
        hp = self.method.hp
        tp = self.train_params
        end_iter = end_iter if end_iter is not None else hp.training_end_iter
        t_start = time.time()
        it = int(self.method.iter_nr)
        it_start = it
        if self.callbacks is not None:
            self.callbacks.training_started()
        while it < end_iter:
            if self.callbacks is not None:
                self.callbacks.iter_started(iter_nr=it)
            if (getattr(self.method, "grid", None) is not None
                    and it % self.update_occupancy_every == 0):
                self.method.update_occupancy_grid()
            losses = self.train_iteration()
            it = int(self.method.iter_nr)
            self._adjust_ray_bucket(losses, it)

            if it % self.log_every == 0 or it == end_iter:
                loss_val = float(losses["loss"])
                iters_per_sec = (it - it_start) / max(time.time() - t_start, 1e-9)
                self.loss_history.append((it, loss_val))
                print(f"iter {it}/{end_iter} loss {loss_val:.5f} ({iters_per_sec:.1f} it/s)",
                      flush=True)
            if self.callbacks is not None:
                self.callbacks.iter_ended(iter_nr=it, losses=losses)
            if callback is not None:
                callback(it, self.method, losses)

            if tp is not None:
                if tp.compute_test_loss and it % tp.compute_test_loss_freq == 0:
                    tl = self.estimate_test_loss()
                    if tl is not None:
                        print(f"iter {it} test loss {tl:.5f}", flush=True)
                if it % tp.render_freq == 0 and "test" in self.mv_data.splits:
                    from volsurfs_tpu_torch.utils.rendering import (
                        render_from_camera,
                        save_image_png,
                    )

                    cams = self.mv_data["test"].cameras
                    buffers = render_from_camera(self, cams[it // tp.render_freq % len(cams)])
                    for name, img in buffers.items():
                        save_image_png(img, os.path.join(self.run_dir, "renders", name),
                                       f"{it:07d}")
                if tp.save_checkpoints and it % tp.checkpoint_freq == 0:
                    self.save_checkpoint()
        if self.callbacks is not None:
            self.callbacks.training_ended()
        self.save_checkpoint()
        return self.method

    def render_camera(self, camera, chunk_size: int = 2048) -> dict:
        """Full frame as numpy: each output of the method's render function
        as [H, W, C] ({"rgb": [H, W, 3], "bg_transmittance": [H, W, 1]}, and
        offsets_surfs' "surfs_alpha" [H, W, K]); averages
        hp.nr_test_rays_per_pixel jittered frames when it is above 1 (the
        jitter drawn from ``self.generator``)."""
        render_fn = self.method.make_render_fn()
        ss = max(int(self.method.hp.nr_test_rays_per_pixel), 1)
        H, W = camera.height, camera.width
        acc = None
        for _ in range(ss):
            if ss == 1:
                rays = get_camera_rays(camera)
            else:
                rays = get_camera_rays(camera, jitter_pixels=True, generator=self.generator)
            rays_o, rays_d = (torch.from_numpy(x).to(self.device) for x in rays)
            out = render_frame_chunked(render_fn, rays_o, rays_d, chunk_size)
            out = {k: v.cpu().numpy() for k, v in out.items()}
            acc = out if acc is None else {k: acc[k] + out[k] for k in acc}
        return {k: (v / ss).reshape(H, W, -1) for k, v in acc.items()}

    def eval_split(self, split_name: str, max_cameras: int | None = None,
                   chunk_size: int = 2048) -> dict:
        """Render and score a split (psnr, ssim, lpips_rf); writes
        run_dir/results/<split>.csv and returns the means."""
        split = self.mv_data[split_name]
        evaluator = PerSceneEvaluator(split_name)
        cams = split.cameras[:max_cameras] if max_cameras else split.cameras
        for i, cam in enumerate(cams):
            out = self.render_camera(cam, chunk_size)
            evaluator.update(cam.camera_id, split.rgbs[i], out["rgb"].clip(0, 1))
        evaluator.save_csv(os.path.join(self.run_dir, "results"))
        return evaluator.means()


def _repo_config(*parts):
    return os.path.join(os.path.dirname(__file__), "..", "..", "config", *parts)


def load_shells(meshes_path: str, hp):
    """The .obj shells of meshes_path in sorted order, or the subset
    hp.meshes_indices selects: (file names, [(verts, faces, uvs), ...])."""
    from volsurfs_tpu_torch.baking.mesh_io import load_obj

    mesh_files = sorted(f for f in os.listdir(meshes_path) if f.endswith(".obj"))
    if getattr(hp, "meshes_indices", None):
        mesh_files = [mesh_files[int(i)] for i in sorted(hp.meshes_indices)]
    return mesh_files, [load_obj(os.path.join(meshes_path, f)) for f in mesh_files]


def main(argv=None):
    """CLI of the JAX trainer's flags, plus --device (default cuda; on a
    host without CUDA it raises unless --device cpu)."""
    from volsurfs_tpu_torch.params.params import DataParams, PathsParams, TrainParams, init_run

    parser = argparse.ArgumentParser("volsurfs_tpu_torch trainer")
    parser.add_argument("--method", required=True, choices=list(METHODS))
    parser.add_argument("--dataset", default="synthetic")
    parser.add_argument("--scene", default="sphere")
    parser.add_argument("--exp_name", default="default")
    parser.add_argument("--run_id", default=None)
    parser.add_argument("--exp_config", default=None, help="hjson experiment config")
    parser.add_argument("--paths_config", default=None)
    parser.add_argument("--train_config", default=None)
    parser.add_argument("--data_config", default=None)
    parser.add_argument("--datasets_path", default=None, help="override paths cfg")
    parser.add_argument("--runs_path", default=None, help="override paths cfg")
    parser.add_argument("--models_path", default=None,
                        help="models dir of a previous stage: offsets_surfs takes a surf "
                             "run's sdf.pt from there, and a method with a trained "
                             "background its bg.pt")
    parser.add_argument("--meshes_path", default=None,
                        help="directory of .obj shells for volsurfs")
    parser.add_argument("--train_iters", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--subsample_factor", type=int, default=None)
    parser.add_argument("--occupancy_res", type=int, default=256)
    parser.add_argument("--continue_training", action="store_true")
    parser.add_argument("--data_parallel", action="store_true",
                        help="not ported (ROADMAP.md Queue 1 item 9)")
    parser.add_argument("--eval_test", action="store_true")
    parser.add_argument("--eval_train", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    if args.data_parallel:
        raise NotImplementedError("--data_parallel is not ported (ROADMAP.md Queue 1 item 9)")
    device = resolve_device(args.device)

    if args.exp_config is None:
        base = "base_5.cfg" if args.method in ("offsets_surfs", "volsurfs") else "base.cfg"
        args.exp_config = _repo_config(args.method, base)
    paths_cfg = args.paths_config or _repo_config("paths_config.cfg")
    train_cfg = args.train_config or _repo_config("train_config.cfg")
    data_cfg = args.data_config or _repo_config("data_config.cfg")
    paths = PathsParams(paths_cfg if os.path.exists(paths_cfg) else None,
                        datasets=args.datasets_path, runs=args.runs_path)
    train_params = TrainParams(args.method, train_cfg if os.path.exists(train_cfg) else None)
    data_params = DataParams(args.dataset, args.scene,
                             data_cfg if os.path.exists(data_cfg) else None)

    hp = get_method_hyper_params(args.method, args.exp_config)
    if args.train_iters is not None:
        hp.training_end_iter = args.train_iters
    if args.lr is not None:
        hp.lr = args.lr

    config = dict(data_params.dict)
    if args.subsample_factor is not None:
        config["subsample_factor"] = args.subsample_factor
    mv_data = MVDataset(args.dataset, args.scene, paths.datasets_path, config=config)

    run_dir, _ = init_run(
        paths.runs_path, args.method, args.exp_name, args.scene,
        run_id=args.run_id, continue_training=args.continue_training,
        config_files={
            "exp_config": args.exp_config,
            "train_config": train_cfg if os.path.exists(train_cfg) else None,
            "data_config": data_cfg if os.path.exists(data_cfg) else None,
        },
    )
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump({k: str(v) for k, v in vars(args).items()}, f, indent=2)

    method_kwargs = {}
    if args.method == "volsurfs":
        if args.meshes_path is None:
            raise SystemExit("volsurfs requires --meshes_path with .obj shells")
        method_kwargs["meshes"] = load_shells(args.meshes_path, hp)[1]
    else:
        method_kwargs["occupancy_res"] = args.occupancy_res
    method = make_method(args.method, hp, make_bounding_sphere(mv_data.scene_radius),
                         mv_data.bg_color or data_params.bg_color, seed=args.seed,
                         device=device, **method_kwargs)
    # cross-stage transfer: a surf run's SDF into offsets_surfs' main surface,
    # a trained background into a method that has one
    if args.models_path:
        sdf_path = os.path.join(args.models_path, "sdf.pt")
        if args.method == "offsets_surfs" and os.path.exists(sdf_path):
            method.load_main_sdf(torch.load(sdf_path, map_location="cpu", weights_only=True))
        bg_path = os.path.join(args.models_path, "bg.pt")
        if "bg" in method.models and os.path.exists(bg_path):
            method.models["bg"].load_state_dict(
                torch.load(bg_path, map_location="cpu", weights_only=True))
    trainer = Trainer(method, mv_data, run_dir, seed=args.seed, train_params=train_params)
    if args.continue_training:
        trainer.load_checkpoint()
    trainer.train()
    if args.eval_test or train_params.eval_test:
        print("test metrics:", trainer.eval_split("test"), flush=True)
    if args.eval_train or train_params.eval_train:
        print("train metrics:", trainer.eval_split("train"), flush=True)
    return run_dir


if __name__ == "__main__":
    main()
