"""Device-resident image stack and random ray batches (counterpart of
volsurfs_tpu/datasets/tensor_reel.py)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class TensorReel:
    rgbs: torch.Tensor  # [N, H, W, 3]
    masks: torch.Tensor  # [N, H, W, 1]
    intrinsics: torch.Tensor  # [N, 3, 3]
    poses: torch.Tensor  # [N, 4, 4]

    @property
    def nr_cameras(self) -> int:
        return self.rgbs.shape[0]


def make_tensor_reel(cameras, rgbs: np.ndarray, masks=None, device="cuda") -> TensorReel:
    if masks is None:
        masks = np.ones((*rgbs.shape[:3], 1), np.float32)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)

    return TensorReel(
        rgbs=put(rgbs),
        masks=put(masks),
        intrinsics=put(np.stack([c.intrinsics for c in cameras])),
        poses=put(np.stack([c.pose for c in cameras])),
    )


def get_next_rays_batch(reel: TensorReel, generator: torch.Generator, batch_size: int,
                        jitter_pixels: bool = True) -> dict:
    """Random (camera, pixel) rays with their ground truth, made on the
    reel's device with ``generator`` (which lives on that device).

    Returns rays_o, rays_d [B, 3], gt_rgb [B, 3], gt_mask [B, 1], camera_idx [B].
    """
    dev = reel.rgbs.device
    _, H, W, _ = reel.rgbs.shape
    cam_idx = torch.randint(0, reel.nr_cameras, (batch_size,), generator=generator, device=dev)
    px = torch.randint(0, W, (batch_size,), generator=generator, device=dev)
    py = torch.randint(0, H, (batch_size,), generator=generator, device=dev)
    if jitter_pixels:
        sub = torch.rand((batch_size, 2), generator=generator, device=dev)
    else:
        sub = torch.full((batch_size, 2), 0.5, device=dev)
    pixels = torch.stack([px.float(), py.float()], dim=-1) + sub

    intr = reel.intrinsics[cam_idx]
    pose = reel.poses[cam_idx]
    x = (pixels[:, 0] - intr[:, 0, 2]) / intr[:, 0, 0]
    y = (pixels[:, 1] - intr[:, 1, 2]) / intr[:, 1, 1]
    dirs_cam = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    dirs = torch.einsum("bij,bj->bi", pose[:, :3, :3], dirs_cam)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return {
        "rays_o": pose[:, :3, 3].contiguous(),
        "rays_d": dirs.contiguous(),
        "gt_rgb": reel.rgbs[cam_idx, py, px],
        "gt_mask": reel.masks[cam_idx, py, px],
        "camera_idx": cam_idx,
    }
