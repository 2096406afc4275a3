"""Times the port's CUDA kernels at the shapes of the volsurfs main path.

    python -m volsurfs_tpu_torch.kernel_bench

- K1 ``scatter_add_rows``: one HashGrid2D backward of the train step (16
  levels x 4 lerp corners x 512 rays x 4 hash corners, F=2, into the
  355,278-row table) and the same updates all into 8 rows;
- K2 ``trace_all`` on the five shells of
  ``runs/pipeline_tpu_256/volsurfs/meshes/``: the train step's 5 x 512 rays
  (drawn from the tensor reel as the train step draws them, fixed seed),
  one 16,384-ray render chunk (the test frame's second, rows 64-127, the
  one with the most hits) and the whole 256x256 frame (5 x 65,536 rays).

Prints the card's name and power limit, then one JSON line per (kernel,
shape) with ``ms`` (median of CUDA-event timings) and ``device_ms`` (device
time in a torch.profiler trace, and ``device_split``, the same by device
event). It calls only the kernels' public
wrappers, so the same file times any tree of the port: copied into another
checkout's ``volsurfs_tpu_torch/``, with ``datasets/sphere_scene.py``, it
times that checkout's kernels. ``chip_smoke.py`` builds its kernel checks
on the same inputs and timers.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from volsurfs_tpu_torch.datasets.sphere_scene import FRAME, load_shells, test_camera, train_split

TRAIN_RAYS = 512  # training_rays_batch_size of config/volsurfs/base_5.cfg
CHUNK = 16384  # rays of one render chunk


def time_ms(fn, reps=20, warmup=3):
    """Median of reps CUDA-event timings of one fn() call, after warmup
    calls. A spin kernel queued before the start event keeps the device
    busy while the host enqueues fn's launches, so the events time the
    device's work rather than the host's issue rate (a wrapper that syncs
    inside is timed to its sync)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_kernels(prof):
    """The device-side events of a profile: kernels, memsets and copies
    (without the ranges that annotations such as ``Optimizer.step`` leave
    on the device timeline)."""
    return [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    ]


def device_times(fn, reps=10):
    """Device time per fn() call by event name (kernels, memsets, copies)
    in a torch.profiler trace of reps calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in device_kernels(prof):
        times[e.name[:60]] = times.get(e.name[:60], 0.0) + e.device_time / reps / 1e3
    return times


def device_ms(fn, reps=10):
    """Device time per fn() call: the sum of ``device_times``."""
    return sum(device_times(fn, reps).values())


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def k1_cases(device, seed=0):
    """{case: (rows int32 [M], upd float32 [M, 2], table rows)} on device."""
    from volsurfs_tpu_torch.models.textures import HashGrid2D

    grid = HashGrid2D()
    sizes = grid.sizes
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    per_level = 4 * TRAIN_RAYS * 4
    rng = np.random.default_rng(seed)
    main_rows = np.concatenate(
        [rng.integers(0, s, per_level) + o for s, o in zip(sizes, offsets)]
    )
    cases = {}
    for case, (rows_np, nr_rows) in {
        "hashgrid_backward": (main_rows, grid.total_rows),
        "collide_8_rows": (rng.integers(0, 8, main_rows.shape[0]), 8),
    }.items():
        rows = torch.from_numpy(rows_np.astype(np.int32)).to(device)
        upd = torch.from_numpy(
            rng.standard_normal((rows_np.shape[0], 2)).astype(np.float32)
        ).to(device)
        cases[case] = (rows, upd, nr_rows)
    return cases


def k2_rays(device, reel, seed=0):
    """{shape: (rays_o, rays_d)} for the three K2 shapes, on device: the
    train step's rays drawn from reel (a tensor reel of the training
    split), a render chunk and the test frame."""
    from volsurfs_tpu_torch.datasets.tensor_reel import get_next_rays_batch

    gen = torch.Generator(device=device).manual_seed(seed)
    batch = get_next_rays_batch(reel, gen, TRAIN_RAYS, jitter_pixels=True)
    rays_o, rays_d, _ = test_camera(device)
    return {
        f"train_5x{TRAIN_RAYS}": (batch["rays_o"], batch["rays_d"]),
        f"chunk_5x{CHUNK}": (rays_o[CHUNK:2 * CHUNK].contiguous(),
                             rays_d[CHUNK:2 * CHUNK].contiguous()),
        f"frame_5x{FRAME * FRAME}": (rays_o, rays_d),
    }


def main():
    from volsurfs_tpu_torch.datasets.tensor_reel import make_tensor_reel
    from volsurfs_tpu_torch.ops import bvh as B
    from volsurfs_tpu_torch.ops import scatter_add as S

    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: needs a CUDA card")
    device = torch.device("cuda")
    smi = card()
    print(smi, flush=True)
    for case, (rows, upd, nr_rows) in k1_cases(device).items():
        fn = lambda: S.scatter_add_rows(rows, upd, nr_rows)  # noqa: E731
        split = device_times(fn)
        print(json.dumps({"bench": "k1_scatter_add", "case": case, "ms": time_ms(fn),
                          "device_ms": sum(split.values()), "device_split": split,
                          "card": smi}), flush=True)
    stacked = B.stack_bvhs([B.build_bvh(v, f) for v, f, _ in load_shells()], device)
    reel = make_tensor_reel(*train_split(), device=device)
    for shape, (rays_o, rays_d) in k2_rays(device, reel).items():
        fn = lambda: B.trace_all(stacked, rays_o, rays_d)  # noqa: E731
        split = device_times(fn)
        print(json.dumps({"bench": "k2_bvh_trace", "shape": shape, "ms": time_ms(fn),
                          "device_ms": sum(split.values()), "device_split": split,
                          "card": smi}), flush=True)
    stacked.check_step_cap()


if __name__ == "__main__":
    main()
