"""Times the port's CUDA kernels at the shapes of the volsurfs main path.

    python -m volsurfs_tpu_torch.kernel_bench [k1] [k2] [k6] [k7] [k8] [k9] [k10]

(all seven without arguments):

- K1 ``scatter_add_rows``: one HashGrid2D backward of the train step (16
  levels x 4 lerp corners x 512 rays x 4 hash corners, F=2, into the
  355,278-row table) and the same updates all into 8 rows;
- K2 ``trace_all`` on the five shells of
  ``runs/pipeline_tpu_256/volsurfs/meshes/``: the train step's 5 x 512 rays
  (drawn from the tensor reel as the train step draws them, fixed seed),
  one 16,384-ray render chunk (the test frame's second, rows 64-127, the
  one with the most hits) and the whole 256x256 frame (5 x 65,536 rays);
- K6 ``permuto_forward`` at base.cfg's width (24 levels, 3,898,240 rows)
  on a data step's 49,152 samples and a refresh chunk's 65,536 points,
  with and without grads, nothing saved for a backward; and one
  differentiable lookup with grads (``permuto_lookup``, the curvature
  term's) at 49,152 samples, forward and backward into the table and the
  points, whatever kernels the tree's backward takes;
- K7 ``occupancy_samples`` on a refreshed 256^3 grid (``k7_grid``) at the
  train steps' 512, 2,048 and 4,096 rays (the surf step, the offsets_surfs
  step, the trainer's largest bucket) and a 16,384-ray render chunk,
  clipped to the occupied probes, 64 samples a ray (``k7_cases``; 512
  rays and the chunk are chip_smoke.py's phase 13 inputs);
- K8 (``csrc/volrender.cu``) at the surf and offsets_surfs data steps'
  shapes (512 rays at K = 1 surface, 2,048 at K = 5; 64 + 16 + 16
  samples; inputs from ``k8_cases``) and the surf eval chunk's (2,048 rays,
  K = 1): ``combine`` at each of a step's three merges, the transmittance
  scan forward and backward on [K x R, 96] rows and each round of
  ``neus_importance``; and K8d ``nerf_importance`` (the nerf step's
  round: 64 samples, 32 new depths; inputs from ``k8d_case``) at 512 and
  2,048 rays, where the tree has it;
- K10 ``contracted_bg_samples`` (the background's samples, contracted;
  inputs from ``k10_case``) at surf's data step (512 rays x 64 samples), an
  eval chunk (2,048 x 64), a sphere-traced 256^2 frame (65,536 x 64) and
  volsurfs' step (512 x 32), jittered where a train step jitters;
- K9 ``sphere_trace_step`` (one march step; ``k9_case``) on a 256^2
  frame's rays at the sphere of the smoke scene, with and without a
  256^3 grid, after 6 steps of the march: the step of the rays still
  marching (an earlier tree's: of every ray), and a whole 24-step
  ``sphere_trace`` (host wall ms, device busy ms, launches).

Prints the card's name and power limit, then one JSON line per (kernel,
shape) with ``ms`` (median of CUDA-event timings of one call) and
``device_ms`` (CUDA events around 10 calls queued back to back behind a
spin kernel, over 10), and ``device_split`` (device time by event name in
a torch.profiler trace, ``profile_calls``). It calls only the kernels' public
wrappers, so the same file times any tree of the port: copied into another
checkout's ``volsurfs_tpu_torch/``, with ``datasets/sphere_scene.py``, it
times that checkout's kernels. ``chip_smoke.py`` builds its kernel checks
on the same inputs and timers.
"""

from __future__ import annotations

import collections
import itertools
import json
import subprocess
import time

import numpy as np
import torch

from volsurfs_tpu_torch.datasets.sphere_scene import FRAME, load_shells, test_camera, train_split

TRAIN_RAYS = 512  # training_rays_batch_size of config/volsurfs/base_5.cfg
CHUNK = 16384  # rays of one render chunk
# K7's train-step rays: surf's step, offsets_surfs' step, the largest bucket
K7_TRAIN_RAYS = (512, 2048, 4096)


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


SPIN_NAME = "spin_kernel"  # the kernel of torch.cuda._sleep
SHORT_SPINS = 200  # ~50 ms of short spins ahead of a trace's calls


def profile_calls(fn, reps, cpu=False, tries=5, spin_cycles=10_000_000):
    """fn() under torch.profiler (CUDA activity, and CPU with cpu=True):
    one call before the trace, then reps calls in it, ended by a
    synchronize, between SHORT_SPINS short spin kernels (~0.25 ms each) and
    a long one (~5 ms). Returns (the device events of the traced calls, host
    wall ms a traced call, the captures taken). Once other traces ran in the
    process, the tracer can lose the first events of a trace (chip_smoke.py
    once read K4 at half its time, and once lost 32 short spins and the
    first call's first kernel in each of 5 captures), so the short spins
    come first to take that loss, and only the events after the last short spin that survived
    and before the long one are kept. A capture without the long spin, with
    no events, or in which some name's count is not a multiple of reps, is
    taken again, up to tries times, and raises if it stays so."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    fn()
    torch.cuda.synchronize()
    faults = []
    for capture in range(1, tries + 1):
        with profile(activities=activities) as prof:
            for _ in range(SHORT_SPINS):
                torch.cuda._sleep(spin_cycles // 20)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3 / reps
            torch.cuda._sleep(spin_cycles)
            torch.cuda.synchronize()
        events = device_kernels(prof)
        spins = [e for e in events if SPIN_NAME in e.name]
        # a short spin lasts a twentieth of the long one: ~0.25 against ~5 ms
        # at 1.98 GHz, and on either side of 3 ms at any clock from 0.7 GHz up
        short = [e.time_range.end for e in spins if e.device_time < 3000]
        long = [e.time_range.start for e in spins if e.device_time >= 3000]
        if len(long) != 1:
            faults.append(f"{len(short)} short and {len(long)} long spins")
            continue
        start = max(short, default=float("-inf"))
        inside = [e for e in events if SPIN_NAME not in e.name
                  and start <= e.time_range.start and e.time_range.end <= long[0]]
        counts = collections.Counter(e.name for e in inside)
        if inside and all(n % reps == 0 for n in counts.values()):
            return inside, wall_ms, capture
        odd = {name[:80]: n for name, n in counts.items() if n % reps}
        faults.append(f"{len(short)} short spins, {len(inside)} events between the spins, "
                      f"{len(events) - len(inside) - len(spins)} outside, odd counts {odd}")
    raise RuntimeError(f"profile_calls: {tries} captures of {reps} calls lost events: {faults}")


def device_times(fn, reps=10):
    """Device time per fn() call by event name (kernels, memsets, copies)
    in a torch.profiler trace of reps calls (``profile_calls``)."""
    events, _, _ = profile_calls(fn, reps)
    times = {}
    for e in events:
        times[e.name[:60]] = times.get(e.name[:60], 0.0) + e.device_time / reps / 1e3
    return times


def device_ms(fn, reps=10, spin_cycles=20_000_000):
    """Device time per fn() call: CUDA events around reps calls queued back
    to back behind a spin kernel (~10 ms, longer than the host takes to
    queue them), so that the device runs them without waiting for the
    host; the elapsed time over reps. Inputs and outputs stay on the card,
    so a call finds them in L2 where they fit."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(fn, reps=10, flush_bytes=256 << 20):
    """Median device time of one fn() call that finds nothing in L2: before
    each call a write of flush_bytes (five times the H100's 50 MB L2)
    evicts what the last call left there, and a short spin kernel keeps the
    device busy while the host queues the call; CUDA events around the call
    alone."""
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        torch.cuda._sleep(200_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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


def k6_inputs(device, n, seed=0):
    """A base-width PermutoEncoder with a table of uniform(-0.5, 0.5) rows
    and n points in its unit cube: uniform in the ball of radius 1 (the
    bounding sphere), 16 at the invalid samples' depth (1e10). Returns
    (encoder, unit points [n, 3], the generator, for more draws)."""
    from volsurfs_tpu_torch.models.encodings import PermutoEncoder

    rng = np.random.default_rng(seed)
    enc = PermutoEncoder().to(device)
    with torch.no_grad():
        enc.table.copy_(torch.from_numpy(
            rng.uniform(-0.5, 0.5, tuple(enc.table.shape)).astype(np.float32)))
    pts = rng.standard_normal((n, 3))
    pts *= rng.uniform(0, 1, (n, 1)) ** (1 / 3) / np.linalg.norm(pts, axis=-1, keepdims=True)
    pts[:16] = 1e10
    unit = (torch.from_numpy(pts.astype(np.float32)).to(device) / enc.half_sides + 1.0) / 2.0
    return enc, unit.contiguous(), rng


def k7_grid(device, res=256):
    """A 256^3 grid after a refresh at the surf stage's start: |sdf| of a
    sphere of radius 0.5 at the voxel centres, occupancy from the logistic
    density at the first phase's beta (variance 0.3)."""
    from volsurfs_tpu_torch.ops.occupancy import make_grid
    from volsurfs_tpu_torch.utils.schedules import get_logistic_beta_from_variance

    grid = make_grid(res, 2.0, sphere_roi_radius=1.0, device=device)
    values = torch.abs(torch.linalg.norm(grid.voxel_centers(), dim=-1) - 0.5)
    grid = grid.update_values(values)
    return grid.update_occupancy_with_sdf(float(get_logistic_beta_from_variance(0.3)))


def k7_cases(device, reel, grid, seed=0, train_rays=(TRAIN_RAYS,)):
    """{shape: the arguments of occupancy_samples} on grid: a train step's
    rays (each count of train_rays) drawn from reel (a tensor reel of the
    training split) and a 16,384-ray render chunk of the test camera, each
    in the bounding sphere's [t_near, t_far], clipped to the occupied
    probes as base.cfg samples (512 probe and march steps, 64 samples a
    ray)."""
    from volsurfs_tpu_torch.datasets.tensor_reel import get_next_rays_batch
    from volsurfs_tpu_torch.ops.raycast import intersect_bounding_primitive, make_bounding_sphere

    gen = torch.Generator(device=device).manual_seed(seed)
    rays = {}
    for n in train_rays:
        batch = get_next_rays_batch(reel, gen, n, jitter_pixels=True)
        rays[f"train_{n}"] = (batch["rays_o"], batch["rays_d"])
    rays_o, rays_d, _ = test_camera(device)
    rays[f"chunk_{CHUNK}"] = (rays_o[CHUNK:2 * CHUNK].contiguous(),
                              rays_d[CHUNK:2 * CHUNK].contiguous())
    cases = {}
    for shape, (o, d) in rays.items():
        rc = intersect_bounding_primitive(make_bounding_sphere(1.0), o, d)
        jitter = torch.rand(o.shape[0], 1, generator=gen, device=device)
        cases[shape] = (o, d, rc["t_near"].contiguous(), rc["t_far"].contiguous(), grid, jitter,
                        1e-4, 3, 64, 512, 512)
    return cases


# the surf and offsets_surfs data steps' samples: 64 a ray in the occupied
# space and two rounds of 16 importance samples (config/surf/base.cfg,
# config/offsets_surfs/base_5.cfg)
K8_UNIFORM, K8_IMP = 64, 16
# the rays a data step takes, by the number of surfaces: surf stays at its
# configured 512; offsets_surfs' dynamic count settles on the 2,048-ray
# bucket from its first phase on (chip_smoke.py's offsets_train line,
# rays_bucket_by_step). chip_smoke.py passes the buckets its paths ran.
K8_RAYS = {1: TRAIN_RAYS, 5: 4 * TRAIN_RAYS}
K8_EVAL_RAYS = 2048  # the rays of a render chunk of Trainer.render_camera (surf eval: K = 1)
K8_OFFSETS = (0.12, 0.08, 0.04, 0.02, 0.0)  # the base_5 surfaces' offsets of the main SDF


def k8_samples(device, rng, R, S, count=None):
    """RaySamples of R rays in [1, 3]: a sorted valid prefix of
    rng-drawn length in each row (count [R, 1] if given), every 16th ray
    empty, INVALID_Z after it; dt by update_dt."""
    from volsurfs_tpu_torch.ops import samples as TS

    z = np.sort(rng.uniform(1.0, 3.0, (R, S)), axis=1).astype(np.float32)
    if count is None:
        count = rng.integers(S // 4, S + 1, (R, 1))
        count[::16] = 0
    mask = np.arange(S)[None, :] < count
    z = np.where(mask, z, TS.INVALID_Z).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    samples = TS.RaySamples(
        z=t(z), dt=torch.zeros(R, S, device=device), mask=t(mask),
        rays_o=t(np.zeros((R, 3), np.float32)),
        rays_d=t(np.tile(np.float32([[0.0, 0.0, 1.0]]), (R, 1))),
        t_near=t(np.ones((R, 1), np.float32)), t_far=t(np.full((R, 1), 3.0, np.float32)),
        max_dt=t(rng.uniform(0.01, 0.04, (R, 1)).astype(np.float32)))
    return TS.update_dt(samples)


def k8_cases(device, K, R=None, seed=0):
    """The inputs of K8's kernels at a data step of K surfaces (1: surf, 5:
    offsets_surfs) and R rays (K8_RAYS[K] if None): {"combine": {merge:
    (a, b, values_a, values_b)}, "transmittance": (alpha [K*R, 96], mask),
    "importance": {round: (samples, sdfs [R, S, K], beta, n, jitter)}}.
    The first merge's second set repeats some of the first's depths exactly
    and some within the minimum distance; the alphas reach 1; the SDFs
    cross 0 along the rays, one surface a shifted copy of another."""
    R = K8_RAYS[K] if R is None else R
    rng = np.random.default_rng(seed)
    uniform = k8_samples(device, rng, R, K8_UNIFORM)
    full = np.full((R, 1), K8_IMP)
    full[::16] = 0
    imp1, imp2 = (k8_samples(device, rng, R, K8_IMP, full) for _ in range(2))
    # depths of the first merge's b: some equal to a's, some 3e-5 behind
    z = imp1.z.clone()
    both = uniform.mask[:, :4] & imp1.mask[:, :4]
    z[:, :2] = torch.where(both[:, :2], uniform.z[:, :2], z[:, :2])
    z[:, 2:4] = torch.where(both[:, 2:4], uniform.z[:, 2:4] + 3e-5, z[:, 2:4])
    imp1 = imp1.replace(z=torch.sort(z, dim=1).values)

    def sdfs(samples):
        base = 2.0 - samples.z + 0.02 * torch.from_numpy(
            rng.standard_normal(tuple(samples.z.shape)).astype(np.float32)).to(device)
        return (base[..., None] + torch.tensor(K8_OFFSETS[5 - K:], device=device)).contiguous()

    v_u, v_1 = sdfs(uniform), sdfs(imp1)
    combined = k8_samples(device, rng, R, K8_UNIFORM + K8_IMP)
    imp = k8_samples(device, rng, R, 2 * K8_IMP)
    S = K8_UNIFORM + 2 * K8_IMP
    alpha = rng.uniform(0.0, 0.4, (K * R, S)).astype(np.float32)
    alpha[rng.uniform(0, 1, alpha.shape) < 0.05] = 1.0
    mask = np.arange(S)[None, :] < rng.integers(0, S + 1, (R, 1))
    jitter = lambda: torch.from_numpy(  # noqa: E731
        rng.uniform(-0.5, 0.5, (R, K8_IMP)).astype(np.float32)).to(device)
    return {
        "combine": {f"{K8_UNIFORM}+{K8_IMP}": (uniform, imp1, v_u, v_1),
                    f"{K8_IMP}+{K8_IMP}": (imp1, imp2, None, None),
                    f"{K8_UNIFORM}+{2 * K8_IMP}": (uniform, imp, None, None)},
        "transmittance": (torch.from_numpy(alpha).to(device),
                          torch.from_numpy(np.tile(mask, (K, 1))).to(device)),
        "importance": {f"{K8_UNIFORM}": (uniform, v_u, 18.5, K8_IMP, jitter()),
                       f"{K8_UNIFORM + K8_IMP}": (combined, sdfs(combined), 37.0, K8_IMP,
                                                  jitter())},
    }


# the nerf step's importance round (config/nerf/base.cfg): 64 samples a ray
# in the occupied space, 32 new depths; chip_smoke.py passes the rays of
# its path's last steps and a render chunk's (K8_EVAL_RAYS)
K8D_UNIFORM, K8D_IMP = 64, 32


def k8d_case(device, R, S=K8D_UNIFORM, n=K8D_IMP, seed=0, count=None):
    """The inputs of K8d (the nerf importance round) at R rays of S samples:
    (samples, density [R, S], n, jitter [R, n]). The samples as
    k8_samples draws them (count [R, 1] if given); the density a bump of
    height 50 around a surface at a random depth a ray, over a floor in
    [0, 0.5), with 10% of the samples at 0 and every 7th ray opaque (1e4)
    over four samples, where the transmittance underflows."""
    rng = np.random.default_rng(seed)
    samples = k8_samples(device, rng, R, S, count)
    z = samples.z.cpu().numpy().astype(np.float64)
    surface = rng.uniform(1.5, 2.5, (R, 1))
    density = 50.0 * np.exp(-np.minimum(((z - surface) / 0.05) ** 2, 80.0))
    density += rng.uniform(0.0, 0.5, (R, S))
    density[rng.uniform(0, 1, (R, S)) < 0.1] = 0.0
    density[::7, S // 4:S // 4 + 4] = 1e4
    jitter = rng.uniform(-0.5, 0.5, (R, n)).astype(np.float32)
    return (samples, torch.from_numpy(density.astype(np.float32)).to(device), n,
            torch.from_numpy(jitter).to(device))


# K10's shapes on the paths (rays, samples a ray, jittered): surf's and
# nerf's data step (nr_samples_bg 64 in their base.cfg), an eval chunk, a
# sphere-traced 256^2 frame, volsurfs' step (nr_samples_bg's default, 32)
K10_CASES = {"surf_step": (512, 64, True), "eval_chunk": (2048, 64, False),
             "traced_frame": (65536, 64, False), "volsurfs_step": (512, 32, True)}
# a row that is not a multiple of a warp, jittered: checked beside K10_CASES
K10_CHECK_CASES = {"n48_jittered": (512, 48, True)}
# operations of one sample in K10's plain version (ops/samplers.py): the
# inverse depth (s, the reciprocal, the sums, the clamp: 7), the jitter's
# lerp (3), the gap and its max (2), the point o + t d (6), the contraction
# (the doubled point 3, the norm's product, two fmas and root 4, the clamp,
# the factor 2, the scaled point 6, the select: 17), the distance (the
# difference 3, the norm 4) and its gap (the difference, the clamps: 3);
# none an FMA, so a bound counts them at the card's issue rate
# (ISSUE_PER_S), not at its float32 rate, which counts an FMA as two
K10_OPS_A_SAMPLE = 49
# instructions a second the card issues, a thread's each: 4 warp
# instructions a clock on each of the 132 SMs, 128 lanes; the float32 rate
# of 67 TFLOP/s halved (it counts an FMA, a lane a clock, as two)
ISSUE_PER_S = 33.5e12


def k10_case(device, R, N, jitter=True, seed=0):
    """The inputs of K10 at R rays of N samples: (rays_o, rays_d, t_start
    [R, 1], N, jitter [R, N] or None). Origins at radius 2 to 3 around the
    unit bounding sphere, directions toward it; a quarter of the rays miss
    it, and start their background at 0 (t_start, the sphere's far end, is
    0 there)."""
    from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere

    rng = np.random.default_rng(seed)
    o = rng.standard_normal((R, 3))
    o *= rng.uniform(2.0, 3.0, (R, 1)) / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-0.5, 0.5, (R, 3)) - o
    d[: R // 4] = o[: R // 4] + rng.uniform(-0.1, 0.1, (R // 4, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays_o = torch.from_numpy(o.astype(np.float32)).to(device)
    rays_d = torch.from_numpy(d.astype(np.float32)).to(device)
    _, _, t_far, _, _ = make_bounding_sphere(1.0).intersect(rays_o, rays_d)
    u = None
    if jitter:
        u = torch.from_numpy(rng.uniform(0, 1, (R, N)).astype(np.float32)).to(device)
    return rays_o, rays_d, t_far[:, None].contiguous(), N, u


def k10_cost(R, N, jitter):
    """(bytes, operations) of one K10 call: the rays, t_start and, where
    jittered, the jitter read once; the contracted points, the contracted
    distances, gaps and depths, and max_dt written once (the directions are
    the rays', expanded: not written). The operations are issued
    instructions: bound them at ISSUE_PER_S."""
    nbytes = R * (6 * 4 + 4 + 4) + R * N * ((4 if jitter else 0) + 3 * 4 + 3 * 4)
    return nbytes, R * N * K10_OPS_A_SAMPLE


def k10_check(got, ref):
    """K10's outputs (cpos, dirs, the contracted RaySamples, z) against its
    plain version's: every tensor bit for bit. Returns {"max_abs_err",
    "ok", "entries_differ"}."""
    pairs = [(got[0], ref[0]), (got[1], ref[1]), (got[3], ref[3])] + [
        (getattr(got[2], f), getattr(ref[2], f)) for f in ("z", "dt", "mask", "max_dt")]
    errs = [float((g.float() - r.float()).abs().max()) for g, r in pairs]
    differ = sum(int((g != r).sum()) for g, r in pairs)
    return {"max_abs_err": max(errs), "ok": differ == 0, "entries_differ": differ}


def k9_case(device, res=256, grid=True, pre_steps=6, seed=0):
    """A march step's inputs on a 256^2 frame's rays at the smoke scene's
    sphere: (rays_o, rays_d, the SDF function, the TraceSpace, the state
    after pre_steps steps). The SDF is the sphere's analytic distance; the
    grid (with grid) is occupied within 1.5 voxels of it, over the
    bounding sphere's ROI."""
    from volsurfs_tpu_torch.ops import sphere_tracing as ST
    from volsurfs_tpu_torch.ops.occupancy import make_grid
    from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
    from volsurfs_tpu_torch.utils.math import norm3

    rays_o, rays_d, _ = test_camera(device)
    radius = 0.5

    def sdf(p):
        return (norm3(p) - radius)[:, None]

    occupancy = None
    if grid:
        occupancy = make_grid(res, 2.0, sphere_roi_radius=1.0, device=device)
        dist = torch.abs(norm3(occupancy.voxel_centers()) - radius)
        occupancy = type(occupancy)(occupancy.values, (dist < 1.5 * 2.0 / res).view((res,) * 3),
                                    occupancy.roi, occupancy.extent)
    space = ST.trace_space(make_bounding_sphere(1.0), 1e-3, 8e-3, occupancy)
    state = ST.trace_start(rays_o, rays_d, space)
    for _ in range(pre_steps):
        state = ST.sphere_trace_step_reference(state, sdf(rays_o + state[0][:, None] * rays_d)[:, 0],
                                               rays_o, rays_d, space)
    return rays_o, rays_d, sdf, space, state


# operations of one ray's march step in K9's plain version
# (ops/sphere_tracing.py::sphere_trace_step_reference), issued
# instructions: bound them at ISSUE_PER_S
K9_OPS_A_RAY = 150


def k9_cost(R, grid, next_rays=None):
    """(bytes, operations) of one K9 step over R listed rays: a ray's index
    (4 B), its SDF (4), its origin and direction (24) and its state (5
    floats, 3 bools: 23) read once, the state written once, and with a grid
    its occupancy byte; and for each of next_rays rays still marching its
    index and probe point (16) written, and the count (4). next_rays None:
    an earlier tree's step of every ray, which reads no index and writes
    no list. K9_OPS_A_RAY a listed ray."""
    if next_rays is None:
        return R * (24 + 4 + 23 + 23 + (1 if grid else 0)), R * K9_OPS_A_RAY
    nbytes = R * (4 + 4 + 24 + 23 + 23 + (1 if grid else 0)) + next_rays * 16 + 4
    return nbytes, R * K9_OPS_A_RAY


def k9_compacted():
    """Whether this tree's K9 steps a list of active rays (an earlier
    tree's steps every ray)."""
    from volsurfs_tpu_torch.ops import sphere_tracing as ST

    return hasattr(ST, "compact_step_reference")


def k9_step_fn(state, sdf1, rays_o, rays_d, space):
    """fn() for timing one K9 step from state: on a tree that compacts, the
    step of its active rays (sdf1 [N] by ray, the listed rays' taken), each
    call with a zeroed count from a pool zeroed once (so that a call
    launches K9 alone); on an earlier tree, the step of every ray. The step
    updates a copy of state in place, call after call, as a trace does:
    rays that converge stay listed, and step as no-ops. Returns (fn, the
    rays listed, the rays the first step leaves marching)."""
    from volsurfs_tpu_torch.ops import sphere_tracing as ST

    work = tuple(x.clone() for x in state)
    if not k9_compacted():
        return (lambda: ST.sphere_trace_step(work, sdf1, rays_o, rays_d, space),
                rays_o.shape[0], None)
    active, _ = ST.active_rays(state, rays_o, rays_d)
    listed = sdf1.index_select(0, active).contiguous()
    pool = torch.zeros(4096, dtype=torch.int32, device=rays_o.device)
    calls = itertools.count()

    def fn():
        slot = next(calls) % pool.shape[0]
        return ST.sphere_trace_step(work, active, listed, rays_o, rays_d, space,
                                    pool[slot:slot + 1])

    fn()
    next_rays = int(pool[0])
    # the first call's step, in place: start the timed calls from state
    for x, y in zip(work, state):
        x.copy_(y)
    return fn, active.shape[0], next_rays


def k9_march_check(rays_o, rays_d, sdf, space, state, steps=24):
    """March steps from state with the kernel and the plain version side by
    side, each step's SDF evaluated once at the kernel's probe points and
    given to both by ray: after every step every state tensor of every ray
    bit for bit, and the same rays listed with the same probe points. On
    an earlier tree (a step of every ray), every state tensor after every
    step. Returns {"steps", "ok", "entries_differ", "max_abs_err",
    "active_after"}."""
    from volsurfs_tpu_torch.ops import sphere_tracing as ST

    kernel = tuple(x.clone() for x in state)
    plain = tuple(x.clone() for x in state)
    differ, max_err = 0, 0.0

    def compare(got, ref):
        nonlocal differ, max_err
        for g, r in zip(got, ref):
            if g.numel():
                differ += int((g != r).sum())
                max_err = max(max_err, float((g.float() - r.float()).abs().max()))

    if not k9_compacted():
        for _ in range(steps):
            sdf1 = sdf(rays_o + kernel[0][:, None] * rays_d)[:, 0].contiguous()
            plain = ST.sphere_trace_step_reference(plain, sdf1, rays_o, rays_d, space)
            kernel = ST.sphere_trace_step(kernel, sdf1, rays_o, rays_d, space)
            compare(kernel, plain)
        return {"steps": steps, "ok": differ == 0, "entries_differ": differ,
                "max_abs_err": max_err, "active_after": int((~kernel[7]).sum())}

    active_k, points_k = ST.active_rays(state, rays_o, rays_d)
    active_p = active_k.clone()
    by_ray = torch.zeros(rays_o.shape[0], dtype=torch.float32, device=rays_o.device)
    taken = 0
    for _ in range(steps):
        if not active_k.shape[0]:
            break
        sdf_k = sdf(points_k)[:, 0].contiguous()
        by_ray[active_k.long()] = sdf_k
        kernel, active_k, points_k, count_k = ST.sphere_trace_step(
            kernel, active_k, sdf_k, rays_o, rays_d, space)
        plain, active_p, points_p, _ = ST.compact_step_reference(
            plain, active_p, by_ray[active_p.long()], rays_o, rays_d, space)
        m = int(count_k)
        active_k, points_k = active_k[:m], points_k[:m]
        taken += 1
        compare(kernel, plain)
        # the lists, each in its order: the same rays, the same points
        order_k, order_p = torch.argsort(active_k), torch.argsort(active_p)
        if m != active_p.shape[0]:
            differ += abs(m - active_p.shape[0]) + 1
            break
        compare((active_k[order_k], points_k[order_k]), (active_p[order_p], points_p[order_p]))
    return {"steps": taken, "ok": differ == 0, "entries_differ": differ,
            "max_abs_err": max_err, "active_after": int((~kernel[7]).sum())}


def k8_check(kind, got, ref):
    """K8's kernel outputs (got) against its plain version's (ref), as
    tuples of tensors in the same order, by the tolerance of each kind:

    - "combine": bit for bit (it moves and compares values only);
    - "transmittance_fwd": |got - ref| <= 1e-5 |ref| + 1e-7 (the kernel
      multiplies in order, the plain cumprod as a scan: a few float32
      roundings of a product of <= 96 factors);
    - "transmittance_bwd": |got - ref| <= 1e-4 |ref| + 1e-5 max|ref| (the
      reverse recurrence against autograd's cumprod backward, which divides
      by the factors, 1e-6 where alpha is 1);
    - "importance": the masks equal; the depths within 1e-4 but for at
      most 1 in 1,000, and every one within 0.05, under a sample's spacing
      (the CDFs agree within a few float32 roundings, and a target on a flat
      stretch of the CDF, where the weights are ~0, moves along it).

    Returns {"max_abs_err", "ok", "entries_differ"}."""
    errs = [(g.float() - r.float()).abs() for g, r in zip(got, ref)]
    max_abs = max(float(e.max()) if e.numel() else 0.0 for e in errs)
    differ = sum(int((g != r).sum()) for g, r in zip(got, ref))
    if kind == "combine":
        ok = all(torch.equal(g, r) for g, r in zip(got, ref))
    elif kind == "transmittance_fwd":
        ok = all(bool((e <= 1e-5 * r.abs() + 1e-7).all()) for e, r in zip(errs, ref))
    elif kind == "transmittance_bwd":
        ok = all(bool((e <= 1e-4 * r.abs() + 1e-5 * float(r.abs().max())).all())
                 for e, r in zip(errs, ref))
    elif kind == "importance":
        (z, mask), (ref_z, ref_mask) = got, ref
        z_err = (z - ref_z).abs()[ref_mask]
        beyond = float((z_err > 1e-4).float().mean()) if z_err.numel() else 0.0
        ok = torch.equal(mask, ref_mask) and beyond <= 1e-3 and max_abs <= 0.05
    else:
        raise ValueError(kind)
    return {"max_abs_err": max_abs, "ok": bool(ok), "entries_differ": differ}


def bench_k8(device, smi):
    from volsurfs_tpu_torch.ops import samples as TS
    from volsurfs_tpu_torch.ops import volume_rendering as VR

    for K, R in ((1, K8_RAYS[1]), (5, K8_RAYS[5]), (1, K8_EVAL_RAYS)):
        cases = k8_cases(device, K, R)
        for merge, (a, b, va, vb) in cases["combine"].items():
            _bench_line("k8a_combine", lambda: TS.combine(a, b, 1e-4, va, vb), smi, surfaces=K,
                        rays=R, merge=merge)
        alpha, mask = cases["transmittance"]
        _bench_line("k8b_transmittance_fwd", lambda: VR.neus_transmittance(alpha, mask), smi,
                    rows=alpha.shape[0], samples=alpha.shape[1])
        a = alpha.clone().requires_grad_(True)
        g = torch.ones_like(alpha)

        def fwd_bwd():
            w, _, _ = VR.neus_transmittance(a, mask)
            return torch.autograd.grad(w, a, g)

        _bench_line("k8b_transmittance_fwd_bwd", fwd_bwd, smi, rows=alpha.shape[0],
                    samples=alpha.shape[1])
        for rnd, args in cases["importance"].items():
            _bench_line("k8c_importance", lambda: VR.neus_importance(*args), smi, surfaces=K,
                        rays=R, samples=int(rnd))
    for R in (K8_RAYS[1], K8_EVAL_RAYS) if hasattr(VR, "nerf_importance") else ():
        args = k8d_case(device, R)
        _bench_line("k8d_nerf_importance", lambda: VR.nerf_importance(*args), smi, rays=R,
                    samples=K8D_UNIFORM, targets=K8D_IMP)


def bench_k9_k10(device, smi, which):
    from volsurfs_tpu_torch.ops import samplers as SP
    from volsurfs_tpu_torch.ops import sphere_tracing as ST

    if "k10" in which and hasattr(SP, "contracted_bg_samples"):
        for shape, (R, N, jit) in K10_CASES.items():
            args = k10_case(device, R, N, jit)
            _bench_line("k10_bg_samples", lambda: SP.contracted_bg_samples(*args), smi,
                        shape=shape, rays=R, samples=N)
    if "k9" in which and hasattr(ST, "sphere_trace_step"):
        for grid in (False, True):
            rays_o, rays_d, sdf, space, state = k9_case(device, grid=grid)
            sdf1 = sdf(rays_o + state[0][:, None] * rays_d)[:, 0].contiguous()
            fn, listed, next_rays = k9_step_fn(state, sdf1, rays_o, rays_d, space)
            _bench_line("k9_sphere_trace_step", fn, smi, rays=rays_o.shape[0], grid=grid,
                        listed=listed, next_rays=next_rays)
            # a whole 24-step trace through the public entry point: its
            # host wall ms (one host read a step), device busy ms and launches
            bound = space.bounding_primitive

            def trace():
                return ST.sphere_trace(sdf, rays_o, rays_d, bound, 24, 1e-3, space.grid, 8e-3)

            events, wall_ms, _ = profile_calls(trace, 3)
            print(json.dumps({"bench": "k9_sphere_trace", "rays": rays_o.shape[0], "grid": grid,
                              "steps": trace()["steps"], "wall_ms": wall_ms,
                              "device_busy_ms": sum(e.device_time for e in events) / 3e3,
                              "launches": len(events) / 3, "card": smi}), flush=True)


def _bench_line(bench, fn, smi, **fields):
    split = device_times(fn)
    print(json.dumps({"bench": bench, **fields, "ms": time_ms(fn),
                      "device_ms": sum(split.values()), "device_split": split,
                      "card": smi}), flush=True)


def bench_k6(device, smi):
    import inspect

    from volsurfs_tpu_torch.ops import permuto as P

    # an earlier tree's forward takes save= and saves by default
    unsaved = {"save": False} if "save" in inspect.signature(P.permuto_forward).parameters else {}
    for n in (49152, 65536):
        enc, unit, rng = k6_inputs(device, n)
        for grads in (False, True):
            args = (unit, enc.table.detach(), enc.W, enc.level_sizes, enc.level_offsets,
                    enc.ddiff if grads else None)
            _bench_line("k6_forward", lambda: P.permuto_forward(*args, **unsaved), smi,
                        points=n, grads=grads)
        if n == 49152:
            L = enc.nr_levels
            dout = torch.from_numpy(rng.standard_normal((n, 2 * L)).astype(np.float32)).to(device)
            gd = torch.from_numpy(rng.standard_normal((3, n, 2 * L)).astype(np.float32)).to(device)
            lookup_args = (enc.table, enc.W, enc.level_sizes, enc.level_offsets, enc.ddiff)
            points = unit.clone().requires_grad_(True)

            def lookup():
                out = P.permuto_lookup(lookup_args[0], points, *lookup_args[1:])
                return torch.autograd.grad(out, (enc.table, points), (dout, gd))

            _bench_line("k6_lookup_fwd_bwd", lookup, smi, points=n, grads=True)
        del enc


def main(argv=None):
    import sys

    from volsurfs_tpu_torch.datasets.tensor_reel import make_tensor_reel
    from volsurfs_tpu_torch.ops import bvh as B
    from volsurfs_tpu_torch.ops import samplers as SP
    from volsurfs_tpu_torch.ops import scatter_add as S

    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: needs a CUDA card")
    which = set(sys.argv[1:] if argv is None else argv) or {"k1", "k2", "k6", "k7", "k8", "k9",
                                                             "k10"}
    device = torch.device("cuda")
    smi = card()
    print(smi, flush=True)
    if "k1" in which:
        for case, (rows, upd, nr_rows) in k1_cases(device).items():
            _bench_line("k1_scatter_add", lambda: S.scatter_add_rows(rows, upd, nr_rows), smi,
                        case=case)
    reel = make_tensor_reel(*train_split(), device=device)
    if "k2" in which:
        stacked = B.stack_bvhs([B.build_bvh(v, f) for v, f, _ in load_shells()], device)
        for shape, (rays_o, rays_d) in k2_rays(device, reel).items():
            _bench_line("k2_bvh_trace", lambda: B.trace_all(stacked, rays_o, rays_d), smi,
                        shape=shape)
        stacked.check_step_cap()
    if "k6" in which:
        bench_k6(device, smi)
    if "k7" in which:
        cases = k7_cases(device, reel, k7_grid(device), train_rays=K7_TRAIN_RAYS)
        for shape, args in cases.items():
            _bench_line("k7_occupancy_samples", lambda: SP.occupancy_samples(*args), smi,
                        shape=shape)
    if "k8" in which:
        bench_k8(device, smi)
    bench_k9_k10(device, smi, which)


if __name__ == "__main__":
    main()
