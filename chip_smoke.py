#!/usr/bin/env python3
"""Smoke run of the torch port (volsurfs_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's volsurfs slice at the width of config/volsurfs/base_5.cfg
on the five committed shells in runs/pipeline_tpu_256/volsurfs/meshes/,
then its surf stage at the width of config/surf/base.cfg, then its
offsets_surfs stage at the width of config/offsets_surfs/base_5.cfg from
the surf stage's SDF, then the pipeline's mesh baking and volsurfs stage
on the shells of that offsets_surfs model, then the nerf method at the
width of config/nerf/base.cfg:

1. the card's name and power limit (and scipy's version: the pipeline's UV
   atlas needs it, and without it this phase raises);
2. builds the CUDA kernels (one nvcc per csrc/*.cu source, in parallel),
   the native BVH builder and mesh simplifier (g++) into
   volsurfs_tpu_torch/_build/, with each
   kernel's registers and spills as ptxas reports them;
3. kernel K1 (table-gradient scatter-add) against its plain version at the
   train step's shape and at a collision-heavy one, with times;
4. kernel K2 (k-shell BVH trace) against its plain version, bit for bit,
   at three shapes: the train step's 5 x 512 rays (drawn from the tensor
   reel), one 16,384-ray render chunk and a whole 256x256 frame, with times
   (inputs and timers from volsurfs_tpu_torch/kernel_bench.py, the scene
   from volsurfs_tpu_torch/datasets/sphere_scene.py);
5. 60 train steps of 512 rays on the procedural sphere scene through the
   port's Trainer.train (MVDataset "synthetic" at 256x256, 24 train and 4
   test cameras, config/train_config.cfg's cadences, a temporary run
   directory): the median step time after 10 warm-up steps, host clock to
   a torch.cuda.synchronize() in a callback;
6. a 256x256 test frame rendered in 16384-ray chunks, its PSNR and rate,
   and one more frame under the profiler;
7. the launches of both kernels over phases 5-6 (each must be > 0, and the
   plain versions must not have run there);
7a. the rest of the volsurfs stage, from the trained method on: the
   checkpoint saved and loaded into a fresh VolSurfs, whose render_camera
   of test camera 0 must equal the trained one's bit for bit; eval_split
   of the test split (psnr, ssim, lpips_rf); bake_textures and
   export_scene_json at full width (80 band PNGs); the baked scene
   reloaded through BakedMeshRenderer, whose render (unculled) of each of
   the 4 test cameras must lie within a mean 0.15 of Trainer.render_camera,
   and within 0.005 of it with the neural render's alpha decay off;
   then 3 train steps (Trainer.train_iteration) under torch.profiler
   (device-busy time, launches, idle share); the launches over phases 5-7a
   (K1, K2 and K4 each > 0, no plain version);
8. kernel K4 (shade and composite of the baked shells) against its plain
   version on K2's culled buffers of one frame, in pixel tiles as the
   frame path launches it: a 256x256 test camera of the committed baked
   scene (runs/pipeline_tpu_256/volsurfs/, sh_degree 2; 5 x 65,536 rays,
   the replay's shape), a 256x256 and an 800x800 orbit camera of the
   full-width scene of phase 10 (5 x 640,000 rays, the orbit's shape),
   with times, the bound, the entries that differ and the SASS counts of
   the scene's kernel; at each, K4 over the rays in order (width 0, as
   render() launches it) must equal the tiled result bit for bit, and both
   orders are timed warm and with L2 flushed; and K2 as in phase 4, with
   the shells' back-face cull signs, at the orbit's frame shape;
9. the baked renderer's quality replay: the committed scene's 4 test
   cameras at 256x256 through BakedMeshRenderer.render_frame, whose mean
   PSNR must exceed the committed baked_render_psnr less 0.3 dB, and
   through render() in 65,536-ray chunks (traced with no culling, as
   JAX's render is), whose image of camera 0 must equal render_rays of
   the same rays in one call;
10. the full-width baked scene (bench.py's widths: sh_degree 3, bands of
   [2048, 1024, 512, 256] texels, random texels from a seed, on the five
   committed shells), written as PNGs into a temporary directory, loaded
   through BakedMeshRenderer and drawn as 64 orbit frames at 800x800 with
   render_frames_device: Mrays/s (best of 3, one sync a run) and two frames
   under the profiler (every kernel of a frame by name), in a child process
   (``chip_smoke.py --orbit-profile SCENE_DIR``) that has traced nothing
   before;
11. the launches of K2 and K4 over phases 9-10 in this process (each must
   be > 0, and the plain versions must not have run there);
12. kernel K6 (the permutohedral lookup, csrc/permuto.cu) against its
   plain versions at the surf stage's shapes: a data step's 49,152 samples
   with grads and the points' gradient (the curvature term's SDF lookup)
   and without grads (the colour field), a sphere-init step's 30,000
   points and an occupancy-refresh chunk of 65,536 (no backward): the
   forward's feats and dfeats bit for bit, the fused backward's points'
   gradient bit for bit and its table gradient within the atomics' error;
   times of the forward and the backward, their bounds and registers; at
   the curvature shape also K1 on the per-corner updates (the design the
   fused backward replaced) beside index_add_;
13. kernel K7 (the occupied-space sampler, csrc/occupancy_sampler.cu)
   against its plain version on a refreshed 256^3 grid at the train
   step's 512 rays, the offsets_surfs buckets' 2,048 and 4,096 and a
   16,384-ray render chunk, bit for bit, with times
   and the bound (the distinct voxels the rays read, and the operations
   of their points, K7_OPS_A_POINT, at the card's issue rate);
14. the surf stage: config/surf/base.cfg at full width through
   Trainer.train on the sphere scene of phase 5, its schedule cut by one
   factor to 100 sphere-init steps and 300 data steps (the cuts in the
   ``surf_setup`` line): the median step of each phase, the occupancy
   refreshes (every 50 steps) with the occupied fraction after each;
15. the rest of the stage: the checkpoint (grid included) loaded into a
   fresh Surf, whose render of test camera 0 must equal the trained one's
   bit for bit; eval_split of the test split (psnr > 16 dB, the bar of
   tests/test_surf_e2e.py); 3 data steps under the profiler; the launches
   over phases 14-15 (K6 forward and backward, K7 and K8's kernels each >
   0, K1 0, no plain version); the checkpoint's sdf.pt kept for phase 16;
16. the offsets_surfs stage: config/offsets_surfs/base_5.cfg at full width
   (5 surfaces, 4 inner) through Trainer.train on the sphere scene, its
   shared encoder and main head loaded from phase 15's sdf.pt
   (OffsetsSurfs.load_main_sdf), its schedule cut by one factor (1/25: at
   1/50 the test psnr of 10 runs spread over 13.84-16.24 dB, one run in 14
   had fallen below the bar, and the runs whose occupancy grid dipped to
   ~2% scored lowest; at 1/25 the median rose to ~17.9 dB, but one run in
   15 still fell below the bar after its grid collapsed; chip_stage_runs.py
   repeats the stage), but for the offsets-init phase, cut to
   OFFSETS_INIT_STEPS (the later phases' ends move by the difference): 400
   offsets-init, 40 color-init, 1,680 first-phase and 200 second-phase
   steps (the cuts in the ``offsets_setup`` line): the median step of
   each phase, the offsets-init loss (it must fall), the occupancy
   refreshes;
17. the rest of that stage: the checkpoint loaded into a fresh
   OffsetsSurfs, whose render of test camera 0 (rgb and every surface's
   opacity) must equal the trained one's bit for bit; eval_split of the
   test split (psnr > 13 dB, the offsets bar of
   tests/test_pipeline_e2e.py); 3 data steps under the profiler; the
   launches over phases 16-17 (K6, K7 and K8's kernels each > 0, K1 0, no
   plain version);
18. kernel K8 (csrc/volrender.cu: combine, the NeuS transmittance scan
   forward and backward, importance sampling) against its plain versions
   at the surf (K = 1 surface) and offsets_surfs (K = 5) data steps'
   shapes, each at the ray count its path's last steps took (the
   trainers' dynamic-count buckets: 512 and 2,048 on the card), and at
   the surf eval chunk's (K = 1, Trainer.render_camera's 2,048 rays;
   volsurfs_tpu_torch/kernel_bench.py's k8_cases and k8_check): combine
   bit for bit at a step's three merges, the scan's outputs and gradient
   and both importance rounds' depths (64 and 80 samples) within stated
   tolerances; times, bounds, registers, and torch.cumprod beside the
   scan;
19. the device marching (volsurfs_tpu_torch/baking/marching.py) against
   the same function on the host: the main surface of phase 16's trained
   model on a 128^3 grid, the same values marched on the card and on the
   CPU: faces equal, vertices within 1e-6;
20. the pipeline's stages 3-5 from phase 16's trained model (the main path
   pipeline_stage): its 5 shells extracted on the card at 96^3 (the
   baker's 256^3 cut: see EXTRACTION_RES)
   (baker.extract_meshes_from_offsets_surfs: one field evaluation, K6
   without grads, then a march a surface), simplified at 0.025 and
   atlased on the host; the volsurfs stage at config/volsurfs/base_5.cfg's
   width on those shells through Trainer.train (60 steps, as phase 5);
   eval_split of the test split (psnr > 14 dB); the textures and
   scene.json baked into the run directory, which BakedMeshRenderer
   renders on the test cameras (psnr against the ground truth > 13 dB;
   both bars tests/test_pipeline_e2e.py's); every shell with more than 10
   vertices and faces; the seconds of each step, the shells' raw and
   simplified sizes, the peak memory and the launches over the path (K6,
   K1, K2 and K4 each > 0, no plain version);
21. the nerf stage: config/nerf/base.cfg at full width (Density 32-32-32
   with 32 geometry features, RGB 128-128-64 at SH degree 3, two 24-level
   permutohedral tables, 512 rays dynamic, 64 + 32 samples, a 256^3
   grid) through Trainer.train on the sphere scene of phase 5, its
   schedule cut by one factor, NERF_SCALE (the cuts in the
   ``nerf_setup`` line; the sparsity term's gate past step 5,000 is not
   cut): the median step, the loss, the occupancy refreshes (every 50
   steps) with the occupied share after each;
22. the rest of that stage: the checkpoint (grid included) loaded into a
   fresh NeRF, whose render of test camera 0 must equal the trained one's
   bit for bit; eval_split of the test split (psnr > 14 dB, the bar of
   tests/test_nerf_e2e.py); 3 steps under the profiler; the launches over
   phases 21-22 (K6 forward and backward, K7, K8a, K8b forward and
   backward and K8d each > 0, K1 and K8c 0, no plain version) and the
   path's seconds beside its 60 s budget;
23. kernel K8d (csrc/volrender.cu: the nerf importance round) against its
   plain version at the nerf step's shape (the rays of the path's last
   steps, 64 samples, 32 new depths) and a 2,048-ray render chunk's
   (kernel_bench.k8d_case), with times, the bound and registers;
24. the surf stage with the trained background (the main path
   surf_bg_stage): config/surf/base.cfg at full width, phase 14's cut,
   with bg_color "trained" (NerfHash: a 24-level permutohedral table over
   the contracted space, 64-64-64-65 and 64-64-3 MLPs, 64 background
   samples a ray: kernel K10) through Trainer.train: the median step, the
   losses and the refreshes;
25. its checkpoint (bg included) loaded into a fresh Surf, whose render of
   test camera 0 must equal the trained one's bit for bit; eval_split of
   the test split (psnr > 16 dB, the surf bar); the background field's mean
   |rgb_bg - 1| over test camera 0's background pixels (< BG_WHITE_BAR:
   the scene's background is white);
26. the sphere-traced render of test camera 0 (make_render_fn(
   sphere_traced=True): kernel K9 a march step, the trained grid):
   psnr > 16 dB, the share of pixels whose hit differs from the volume
   render's weights_sum > 0.5, the steps and the seconds a frame; then,
   as a witness without a bar, the same trace capped at 100 steps;
28. 3 profiled data steps beside the surf_stage path's; then the path's
   launches (phases 24-26 and 28: K6 forward and backward, K7, K8a, K8b
   forward and backward, K8c, K9 and K10 each > 0, K1 0, no plain
   version);
27. after the path's launches were read: K10 against its plain version at
   kernel_bench.K10_CASES' shapes (512 x 64, 2,048 x 64, 65,536 x 64 and
   volsurfs' 512 x 32) and at 512 x 48, jittered, bit for bit; K9's
   compacted march of test camera 0's 65,536 rays (the active rays only)
   against the compacted plain march over 24 steps, each step given the
   same SDF by ray, at an analytic sphere (without and with a 256^3 grid)
   and at the trained field and grid, bit for bit; K6's forward at the
   background's contracted points, bit for bit; the compacted trace at the
   trained field against JAX's lockstep loop with the plain step (t and
   flags: at most K9_TRACE_HIT_SHARE of the rays hit in one only, t within
   K9_TRACE_DT where both hit), each trace's device busy ms and launches
   (the lockstep one with every ray stepped by K9, the trace's shape before
   compaction), and the traced frame's psnr by each; times, bounds and
   registers;
29. the volsurfs stage at config/volsurfs/base_5.cfg's width on the
   committed sphere-scene shells with the trained background, carried
   from phase 24's model by pipeline._carry_bg (the main path
   volsurfs_bg_stage, counts reset before it): 60 steps (as phase 5), then
   eval_split (psnr > 14 dB, the pipeline's volsurfs bar); its launches
   (K1, K2, K6 forward and backward, K8b forward and backward and K10 each
   > 0, no plain version; no K4: the neural render shades no baked
   texture).

The main paths, each with the launch counts set to 0 before it and read
after it: train_render (phases 5-6), volsurfs_stage (phases 5-7a: it
begins with train_render, from one reset), baked_render (phases 9-10),
surf_stage (phases 14-15), offsets_stage (phases 16-17),
pipeline_stage (phase 20), nerf_stage (phases 21-22), surf_bg_stage
(phases 24-26 and 28) and volsurfs_bg_stage (phase 29).

Each phase prints one JSON line. The line before the last is the kernel
table; the last line is {"ok": true, "device": {...}}. Any failure raises
and exits non-zero; a watchdog turns a hang into a traceback and an exit
after 700 s. Needs a CUDA device; imports nothing of JAX.
"""

import faulthandler

faulthandler.dump_traceback_later(700, exit=True)

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(REPO, "config", "volsurfs", "base_5.cfg")
TRAIN_CFG = os.path.join(REPO, "config", "train_config.cfg")

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# instructions a second the card issues, a thread's each: 4 warp
# instructions a clock on each of the 132 SMs, 128 lanes, the float32 rate
# above (an FMA, two flops, a lane a clock) halved
ISSUE_PER_S = F32_FLOPS_PER_S / 2
# operations of one point of K7's passes, as the plain version
# (ops/samplers.py::_probe, OccupancyGrid.check_occupancy) computes it: the
# midpoint t0 + (k + 0.5) * seg (4, the step's conversion included), the
# point o + t d (6), the voxel coordinate p / extent + 0.5 times res (9,
# the quotient counted as one operation: a product where the extent is a
# power of two), floors (3), conversions (3), the bounds tests (8: six
# comparisons, two ands), the clamps (6), the row-major index (4), one
# byte load (1) and the mask's two ands (2)
K7_OPS_A_POINT = 46
# operations counted for the trace bound: one slab box test of an inner
# node, one Moller-Trumbore test of a real leaf triangle (fmas counted as
# two)
BOX_TEST_FLOPS = 24
TRIANGLE_TEST_FLOPS = 50

# K4 against its plain version: the largest |difference| allowed in rgb and
# bg_transmittance. The two sum the SH terms in other orders, so a float16
# SH value may round one step apart; through the sigmoid and the float16
# compositing over five shells that moves an output by a few float16 steps
# of [0, 1] (4.9e-4 each).
K4_ATOL = 2e-3
ORBIT_FRAMES = 64  # bench.py's orbit
ORBIT_RES = 800

TRAIN_STEPS = 60
WARMUP_STEPS = 10
# the surf stage: config/surf/base.cfg, its schedule cut to 100 sphere-init
# and 300 data steps; its test PSNR must pass tests/test_surf_e2e.py's bar
SURF_CFG = os.path.join(REPO, "config", "surf", "base.cfg")
SURF_SPHERE_STEPS = 100
SURF_DATA_STEPS = 300
SURF_PSNR_BAR = 16.0
# the offsets_surfs stage: config/offsets_surfs/base_5.cfg, its schedule cut
# by one factor; its test PSNR must pass tests/test_pipeline_e2e.py's
# offsets bar (1/25: see phase 16 above)
OFFSETS_CFG = os.path.join(REPO, "config", "offsets_surfs", "base_5.cfg")
OFFSETS_SCALE = 1 / 25
# the offsets-init phase's steps: 1/5 of base_5.cfg's 2,000. At 1/25 (80
# steps) the eps heads stay far from their targets (0.0017-0.0066 from the
# main surface): the inner surfaces were still 0.17-0.86 inside it at step
# 1,600 of a stage run and left the extraction grid, so the pipeline path's
# shells 0-3 came out empty
OFFSETS_INIT_STEPS = 400
OFFSETS_PSNR_BAR = 13.0
# whether the offsets_surfs path clips its rays to the occupied space:
# base_5.cfg's clip_rays_to_occupancy (on); chip_stage_runs.py runs either
# setting
OFFSETS_CLIP_TO_OCCUPANCY = True
# the pipeline path (phases 19-20): the shells' extraction grid (cut from
# the baker's 256) and simplification (the baker's), the device marching's
# check grid, and tests/test_pipeline_e2e.py's bars
# (96: at 256^3 the noisy SDF of the cut stages gave 1.88M raw faces a
# shell and 51 s of simplifying and atlasing for one shell on the card's
# host; at 192^3, 0.57-1.31M faces a shell and 111.5 s for five, past the
# path's 90 s; at 128^3 the path took 82-91 s, 51-57 s of it simplifying
# and atlasing, which left the whole run no room under its 620 s once the
# nerf path joined)
EXTRACTION_RES = 96
SIMPLIFY_RATIO = 0.025
MARCHING_CHECK_RES = 128
PIPELINE_VOLSURFS_PSNR_BAR = 14.0
PIPELINE_BAKED_PSNR_BAR = 13.0
# the nerf stage: config/nerf/base.cfg, its schedule cut by one factor;
# its test PSNR must pass tests/test_nerf_e2e.py's bar. The sparsity term's
# gate (past step 5,000, JAX's constant) is not cut, so it stays shut. At
# 1/200 (1,000 steps) the field stayed empty (11.6 dB, the white
# background 10.8); at 1/100 it fills between steps ~650 and ~800 (10 runs
# at 29.20-29.30 dB); 1/125 (1,600 steps) keeps the path in its 60 s
NERF_CFG = os.path.join(REPO, "config", "nerf", "base.cfg")
NERF_SCALE = 1 / 125
NERF_PSNR_BAR = 14.0
NERF_BUDGET_S = 60.0  # the path's time budget (reported, not enforced)
CHUNK_SURF = 16384  # rays of a render chunk (base.cfg's test_rays_batch_size)
PROFILED_STEPS = 3
# the sphere scene as the stage trains on it: 24 train and 4 test cameras
STAGE_DATA = {"width": 256, "height": 256, "nr_train_cameras": 24, "nr_test_cameras": 4}
# the largest mean |baked - neural| of a test camera, the bar of the JAX
# package's bake round trip (tests/test_baker_and_renderer.py)
BAKED_NEURAL_BAR = 0.15
# the largest mean |baked - neural| with the neural render's alpha decay off,
# which the baked scene does not carry: ~7x the largest sound reading on the
# H100 (0.00072), below what a swapped SH band or a dropped row flip gives
BAKED_NEURAL_UNDECAYED_BAR = 0.005

_T0 = time.perf_counter()


def emit(phase, **fields):
    print(json.dumps({"phase": phase, "t_s": round(time.perf_counter() - _T0, 3), **fields}),
          flush=True)


# kernel families whose device time and launches a profile reports apart
WATCHED = ("permuto", "scatter_add", "Memset", "combine_samples", "neus_", "nerf_",
           "bg_samples", "sphere_trace")
# the profiles of the main paths' train steps, by path, for comparisons
PROFILES = {}


def profiled(fn, reps, top=5):
    """fn() run under torch.profiler (CUDA activity; tracing the host's
    ops too took ~70 s of a run and slowed the traced calls): one call
    before the trace, then reps traced calls (kernel_bench.profile_calls).
    Returns per traced call: host wall ms (ending in a synchronize),
    device-busy ms (the sum of kernel times; one stream, so kernels do not
    overlap), kernel launches, the device's idle share of the wall time,
    the top kernels with the most device time (all of them if top is
    None), the device ms and launches of each WATCHED family (events whose
    name holds it), and the captures taken. Raises if the tracer lost
    events in every capture."""
    from volsurfs_tpu_torch.kernel_bench import profile_calls

    kernels, wall_ms, captures = profile_calls(fn, reps)
    busy_ms = sum(e.device_time for e in kernels) / 1e3 / reps
    by_name = {}
    for e in kernels:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.device_time / 1e3 / reps
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    watched = {}
    for family in WATCHED:
        events = [e for e in kernels if family in e.name]
        watched[family] = [sum(e.device_time for e in events) / 1e3 / reps, len(events) / reps]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, kernels=len(kernels) / reps,
                idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
                top_kernels_ms=[[n, round(v, 4)] for n, v in ranked],
                watched_ms_launches=watched, captures=captures)


def _launch_counts():
    from volsurfs_tpu_torch.ops import (bvh, permuto, samplers, samples, scatter_add, shade,
                                        sphere_tracing, volume_rendering)

    return (scatter_add.launches, bvh.launches, shade.launches, permuto.launches,
            samplers.launches, samples.launches, volume_rendering.launches,
            sphere_tracing.launches)


def reset_counts():
    for counts in _launch_counts():
        for key in counts:
            counts[key] = 0


def read_counts():
    out = {}
    for counts in _launch_counts():
        out.update(counts)
    return out


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card")
    if not os.path.isdir(os.path.join(REPO, "volsurfs_tpu_torch")):
        raise SystemExit(f"chip_smoke: no volsurfs_tpu_torch package beside {__file__}")
    from volsurfs_tpu_torch.kernel_bench import card

    smi = card()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    import scipy  # the pipeline path's UV atlas needs it: without it this raises

    emit("device", nvidia_smi=smi, torch_name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, scipy=scipy.__version__)
    return name, smi


def phase_build():
    from volsurfs_tpu_torch import _build

    t = time.perf_counter()
    _build.kernels()
    t_nvcc = time.perf_counter() - t
    t = time.perf_counter()
    _build.bvh_builder()
    _build.mesh_simplifier()
    resources = _build.kernel_resources()
    sass = {name: {key: n for key, n in counts.items() if key != "by_opcode"}
            for name, counts in _build.sass_counts().items()}
    emit("build", nvcc_s=round(t_nvcc, 3), gxx_s=round(time.perf_counter() - t, 3),
         ptxas=resources, k4_sass=sass)
    return resources, sass


def scatter_tolerance(rows, upd, total_rows):
    """|kernel - plain| bound for one output value: 1e-5 relative, plus f32
    summation error of the row's updates (2^-20 of their absolute sum)."""
    from volsurfs_tpu_torch.ops.scatter_add import scatter_add_rows_reference

    return scatter_add_rows_reference(rows, upd.abs(), total_rows) * 2.0**-20


def phase_scatter_add(device):
    """K1 against its plain version: the hash-grid backward's shape (16
    levels of a real HashGrid2D table, 4 lerp corners x 512 rays x 4 hash
    corners per level, F=2), and every update into 8 rows."""
    from volsurfs_tpu_torch import kernel_bench as kb
    from volsurfs_tpu_torch.ops import scatter_add as S

    results = {}
    for case, (rows, upd, nr_rows) in kb.k1_cases(device).items():
        out = S.scatter_add_rows(rows, upd, nr_rows)
        ref = S.scatter_add_rows_reference(rows, upd, nr_rows)
        err = (out - ref).abs()
        tol = 1e-5 * ref.abs() + scatter_tolerance(rows, upd, nr_rows) + 1e-6
        max_abs = float(err.max())
        max_rel = float((err / ref.abs().clamp(min=1e-6)).max())
        if not bool((err <= tol).all()) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"K1 {case}: max abs err {max_abs}, rel {max_rel}")
        calls = {
            "": lambda: S.scatter_add_rows(rows, upd, nr_rows),
            "plain_": lambda: S.scatter_add_rows_reference(rows, upd, nr_rows),
            # yardstick only: the port never calls index_add_
            "library_": lambda: torch.zeros(nr_rows, 2, device=device).index_add_(0, rows, upd),
        }
        times = {}
        for prefix, fn in calls.items():
            times[prefix + "ms"] = kb.time_ms(fn)
            times[prefix + "device_ms"] = kb.device_ms(fn)
        m = rows.shape[0]
        nbytes = 4 * m + 8 * m + 8 * nr_rows  # rows, updates read; table written
        bound_ms = max(nbytes / HBM_BYTES_PER_S, 2 * m / F32_FLOPS_PER_S) * 1e3
        bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= 2 * m / F32_FLOPS_PER_S else "operations"
        results[case] = dict(
            updates=m, rows=nr_rows, max_abs_err=max_abs, max_rel_err=max_rel,
            **times, bound_ms=bound_ms, bound_by=bound_by,
        )
        emit("k1_scatter_add", case=case, **results[case])
    return results["hashgrid_backward"]


def check_trace(stacked, meshes, shape, rays_o, rays_d, build_s=None, cull=None):
    """K2 against its plain version on every shell x these rays (culled
    with the signs cull, if given): every output bit for bit, no cursor
    over its step cap; times and the bound. meshes: the shells' (verts,
    faces)."""
    from volsurfs_tpu_torch import kernel_bench as kb
    from volsurfs_tpu_torch.ops import bvh as B

    table_bytes = sum(x.numel() * x.element_size() for x in (stacked.nodes, stacked.tris))
    node_bytes, tri_bytes = stacked.nodes[0].nbytes, stacked.tris[0].nbytes
    out = B.trace_all(stacked, rays_o, rays_d, cull)
    ref, work = B.trace_all_reference(stacked, rays_o, rays_d, cull, return_work=True)
    stacked.check_step_cap()
    unequal = [key for key in ("is_hit", "depth", "positions", "barycentric", "triangles_id")
               if not torch.equal(out[key], ref[key])]
    depth_err = float((out["depth"] - ref["depth"]).abs().max())
    bary_err = float((out["barycentric"] - ref["barycentric"]).abs().max())
    fn = lambda: B.trace_all(stacked, rays_o, rays_d, cull)  # noqa: E731
    ms, kernel_device_ms = kb.time_ms(fn), kb.device_ms(fn)
    # one timing, warm from the check above: the plain trace takes 0.6-5.6 s
    # a call on the card, three more took ~28 s of the run
    plain_ms = kb.time_ms(lambda: B.trace_all_reference(stacked, rays_o, rays_d, cull),
                          reps=1, warmup=0)
    stacked.check_step_cap()
    k, R = stacked.node_begin.shape[0], rays_o.shape[0]
    # the nodes and triangles these rays read, rays in, (t, id, u, v) out
    nbytes = (work["nodes_read"] * node_bytes + work["triangles_read"] * tri_bytes
              + 24 * R + 16 * k * R)
    flops = (work["box_tests"] * BOX_TEST_FLOPS
             + work["triangle_tests"] * TRIANGLE_TEST_FLOPS)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    result = dict(
        shape=shape, culled=cull is not None, shells=k, rays=R, nodes=int(stacked.nodes.shape[0]),
        triangles=int(stacked.tris.shape[0]), table_bytes=table_bytes,
        bvh_build_s=build_s, hit_frac=float(out["is_hit"].float().mean()),
        unequal_outputs=unequal, depth_max_abs_err=depth_err, bary_max_abs_err=bary_err,
        tri_differ=int((out["triangles_id"] != ref["triangles_id"]).sum()),
        tri_mismatch_beyond_ties=B.face_id_mismatches(meshes, out, ref, rays_o, rays_d),
        step_cap_overflows=int(stacked.step_cap.count.item()), **work,
        ms=ms, device_ms=kernel_device_ms, plain_ms=plain_ms, library_ms=None,
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        max_abs_err=max(depth_err, bary_err),
    )
    emit("k2_bvh_trace", **result)
    if unequal or result["step_cap_overflows"]:
        raise AssertionError(f"K2 disagrees with its plain version: {result}")
    return result


def phase_trace(device, shells, reel):
    """K2 against its plain version at each of the three shapes (the train
    step's rays drawn from reel). Returns each shape's result."""
    from volsurfs_tpu_torch import kernel_bench as kb
    from volsurfs_tpu_torch.ops import bvh as B

    t = time.perf_counter()
    stacked = B.stack_bvhs([B.build_bvh(v, f) for v, f, _ in shells], device)
    build_s = time.perf_counter() - t
    meshes = [(v, f) for v, f, _ in shells]
    return {shape: check_trace(stacked, meshes, shape, rays_o, rays_d, build_s)
            for shape, (rays_o, rays_d) in kb.k2_rays(device, reel).items()}


def smoke_hyper_params():
    """base_5.cfg at its full width; its 15000-step schedule is scaled to
    the 60 steps run here (warmup 500 -> 2, milestones 8000/10000/13000 ->
    32/40/52), as a shorter run at the configured lr."""
    from volsurfs_tpu_torch.params.hyper_params import get_method_hyper_params

    hp = get_method_hyper_params("volsurfs", CFG)
    scale = TRAIN_STEPS / hp.training_end_iter
    hp.nr_warmup_iters = max(1, round(hp.nr_warmup_iters * scale))
    hp.lr_milestones = [round(m * scale) for m in hp.lr_milestones]
    hp.training_end_iter = TRAIN_STEPS
    return hp


def phase_train(device, shells, mv, hp, run_dir, steps=TRAIN_STEPS, prefix="", bg_source=None):
    """steps train steps through Trainer.train; returns the trainer. Its
    lines' phases begin with prefix. With bg_source (a method with a trained
    background) the stage trains one too, from bg_source's, carried by
    pipeline._carry_bg."""
    from volsurfs_tpu_torch.methods.volsurfs import VolSurfs
    from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
    from volsurfs_tpu_torch.params.params import TrainParams
    from volsurfs_tpu_torch.training import callbacks as CB
    from volsurfs_tpu_torch.training.trainer import Trainer

    t = time.perf_counter()
    method = VolSurfs(hp, shells, bg_color="white" if bg_source is None else "trained",
                      bounding_primitive=make_bounding_sphere(1.0), device=device, seed=0)
    if bg_source is not None:
        from volsurfs_tpu_torch.pipeline import _carry_bg

        _carry_bg(bg_source, method)
        if not torch.equal(method.models["bg"].encoder.table, bg_source.models["bg"].encoder.table):
            raise AssertionError("the background was not carried into the volsurfs stage")
    timer = CB.StepTimerCallback(device)
    trainer = Trainer(method, mv, run_dir, log_every=10, seed=0,
                      train_params=TrainParams("volsurfs", TRAIN_CFG),
                      callbacks=CB.CallbacksGroup([timer]))
    n_params = sum(p.numel() for p in method.models.parameters())
    emit(prefix + "train_setup", setup_s=time.perf_counter() - t,
         textures=len(method.models) * (hp.sh_degree + 1),
         params=n_params, rays_per_step=hp.training_rays_batch_size,
         warmup=hp.nr_warmup_iters, milestones=hp.lr_milestones, lr=hp.lr)

    def log(it, _, losses):
        if it % 10 == 0:  # the timer has synchronised: reading the loss costs no wait
            recent = timer.losses()[-10:]
            emit(prefix + "train", step=it, loss=float(losses["loss"]),
                 mean_loss_last_10=float(recent.mean()))

    t = time.perf_counter()
    trainer.train(end_iter=steps, callback=log)
    train_s = time.perf_counter() - t
    losses = timer.losses()
    if not np.isfinite(losses).all():
        raise AssertionError(f"train: losses {losses.tolist()}")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    emit(prefix + "train_done", losses=losses.tolist(), mean_first_10=first, mean_last_10=last,
         median_step_ms=timer.median_ms(WARMUP_STEPS), steps_timed=len(timer.step_ms) - WARMUP_STEPS,
         train_s=train_s, iter_nr=method.iter_nr,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9 if device.type == "cuda" else None)
    if not last < first:
        raise AssertionError(f"loss did not fall: first 10 {first}, last 10 {last}")
    return trainer


def phase_render(device, method, rays_o, rays_d, gt, chunk):
    from volsurfs_tpu_torch.methods.base import render_frame_chunked

    render = method.make_render_fn()
    render_frame_chunked(render, rays_o[:chunk], rays_d[:chunk], chunk)  # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    out = render_frame_chunked(render, rays_o, rays_d, chunk)
    rgb = out["rgb"].cpu().numpy()
    secs = time.perf_counter() - t
    H = W = gt.shape[0]
    if rgb.shape != (H * W, 3) or not np.isfinite(rgb).all():
        raise AssertionError(f"render: bad frame {rgb.shape}")
    mse = float(np.mean((rgb.reshape(H, W, 3).astype(np.float64) - gt) ** 2))
    psnr = float(10.0 * np.log10(1.0 / max(mse, 1e-12)))
    hit = float((out["bg_transmittance"] < 0.999).float().mean())
    emit("render", rays=H * W, chunk=chunk, psnr=psnr, hit_frac=hit, seconds=secs,
         mrays_per_s=H * W / secs / 1e6)
    if device.type == "cuda":
        emit("render_profile", frames=1,
             **profiled(lambda: render_frame_chunked(render, rays_o, rays_d, chunk), 1))
    if hit <= 0.0:
        raise AssertionError("render: no ray hit a shell")
    return psnr


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def phase_stage(device, trainer, hp, shells, chunk):
    """The volsurfs stage after training (phase 7a): checkpoint round trip,
    evaluation, the full-width bake, the reloaded scene against the neural
    render, then the profiled train steps."""
    from volsurfs_tpu_torch.baking import baker
    from volsurfs_tpu_torch.datasets import sphere_scene
    from volsurfs_tpu_torch.methods.volsurfs import VolSurfs
    from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere
    from volsurfs_tpu_torch.renderers.mesh_renderer import BakedMeshRenderer
    from volsurfs_tpu_torch.training import checkpoints
    from volsurfs_tpu_torch.training.trainer import Trainer
    from volsurfs_tpu_torch.utils.evaluation import psnr

    method, mv, run_dir = trainer.method, trainer.mv_data, trainer.run_dir
    test = mv["test"]

    # checkpoint: save, load into a fresh method (other seed), same frame
    t = time.perf_counter()
    path = trainer.save_checkpoint()
    sync(device)
    save_s = time.perf_counter() - t
    fresh = VolSurfs(hp, shells, bg_color="white", bounding_primitive=make_bounding_sphere(1.0),
                     device=device, seed=1)
    t = time.perf_counter()
    checkpoints.load_checkpoint(trainer.ckpt_dir, fresh)
    sync(device)
    load_s = time.perf_counter() - t
    reloaded = Trainer(fresh, mv, os.path.join(run_dir, "reloaded"))
    ref = trainer.render_camera(test.cameras[0], chunk)["rgb"]
    got = reloaded.render_camera(test.cameras[0], chunk)["rgb"]
    result = dict(iter_nr=fresh.iter_nr, files=sorted(os.listdir(path)), bytes=dir_bytes(path),
                  save_s=save_s, load_s=load_s, render_equal=bool(np.array_equal(got, ref)),
                  max_abs_diff=float(np.abs(got - ref).max()))
    emit("stage_checkpoint", **result)
    if not result["render_equal"] or fresh.iter_nr != method.iter_nr:
        raise AssertionError(f"checkpoint round trip differs: {result}")
    del fresh, reloaded

    t = time.perf_counter()
    means = trainer.eval_split("test", chunk_size=chunk)
    emit("stage_eval", split="test", cameras=len(test.cameras), seconds=time.perf_counter() - t,
         **means)

    # bake at full width into the run directory, as the baker CLI does
    t = time.perf_counter()
    files = sorted(f for f in os.listdir(sphere_scene.MESH_DIR) if f.endswith(".obj"))
    baker.copy_meshes_renumbered(sphere_scene.MESH_DIR, files, run_dir)
    stats = {}
    meshes_info = baker.bake_textures(method, run_dir, stats=stats)
    baker.export_scene_json(run_dir, meshes_info, mv, bg_color="white", sh_degree=hp.sh_degree)
    bake_s = time.perf_counter() - t
    with open(os.path.join(run_dir, "scene.json")) as f:
        scene_keys = sorted(json.load(f))
    emit("stage_bake", textures=len(method.models), textures_res=list(hp.textures_res),
         sh_degree=hp.sh_degree, seconds=bake_s, scene_json_keys=scene_keys, **stats)
    # one PNG an SH coefficient: (sh_degree + 1)^2 a shell
    if stats["pngs"] != len(shells) * (hp.sh_degree + 1) ** 2 or "cameras" not in scene_keys:
        raise AssertionError(f"bake: {stats}, scene.json keys {scene_keys}")

    # the reloaded scene against the neural render, unculled as JAX's render
    t = time.perf_counter()
    renderer = BakedMeshRenderer(run_dir, device=device)
    renderer.stacked_bvh  # the lazy BVH build, counted in the load
    reload_s = time.perf_counter() - t
    diffs, undecayed_diffs, between, baked_psnr, neural_psnr = [], [], [], [], []
    decay = hp.with_alpha_decay
    for i, cam in enumerate(test.cameras):
        baked = renderer.render(cam)
        neural = trainer.render_camera(cam, chunk)["rgb"].clip(0, 1)
        if not (np.isfinite(baked).all() and baked.shape == neural.shape):
            raise AssertionError(f"baked render of camera {i}: {baked.shape}")
        diffs.append(float(np.abs(baked - neural).mean()))
        # the baked scene carries no grazing-angle alpha decay: the neural
        # render without it shows what the decay alone accounts for
        hp.with_alpha_decay = False
        try:
            undecayed = trainer.render_camera(cam, chunk)["rgb"].clip(0, 1)
        finally:
            hp.with_alpha_decay = decay
        undecayed_diffs.append(float(np.abs(baked - undecayed).mean()))
        between.append(psnr(neural, baked))
        baked_psnr.append(psnr(test.rgbs[i], baked))
        neural_psnr.append(psnr(test.rgbs[i], neural))
    renderer.stacked_bvh.check_step_cap()
    result = dict(cameras=len(test.cameras), reload_s=reload_s, mean_abs_baked_neural=diffs,
                  bar=BAKED_NEURAL_BAR, with_alpha_decay=decay,
                  mean_abs_baked_neural_without_decay=undecayed_diffs,
                  bar_without_decay=BAKED_NEURAL_UNDECAYED_BAR, psnr_baked_vs_neural=between,
                  psnr_baked=baked_psnr, psnr_neural=neural_psnr)
    emit("stage_reload", **result)
    if max(diffs) >= BAKED_NEURAL_BAR or max(undecayed_diffs) >= BAKED_NEURAL_UNDECAYED_BAR:
        raise AssertionError(f"baked render deviates from the neural render: {result}")

    emit("train_profile", steps=PROFILED_STEPS,
         **profiled(trainer.train_iteration, PROFILED_STEPS))
    method.stacked_bvh.check_step_cap()
    return dict(eval=means, bake=stats, reload=result)


def orbit_cameras(res, n=ORBIT_FRAMES):
    """bench.py's orbit: n cameras at radius 2, elevation 0.3."""
    from volsurfs_tpu_torch.renderers.viewer import OrbitCamera

    cams = []
    for i in range(n):
        oc = OrbitCamera(res, res, radius=2.0)
        oc.azimuth = 2.0 * 3.14159265 * i / n
        oc.elevation = 0.3
        cams.append(oc.camera())
    return cams


def phase_shade(scene_name, renderer, camera, sass):
    """K4 against its plain version on K2's buffers of one camera's rays,
    culled as the frame entry points cull them and shaded in pixel tiles as
    they shade them; K4 over the same rays in order (width 0, as render()
    and render_rays launch it) must equal the tiled result bit for bit.
    Times of both orders, warm and with L2 flushed, the bound and the SASS
    counts of the scene's kernel."""
    from volsurfs_tpu_torch import kernel_bench as kb
    from volsurfs_tpu_torch.ops import bvh as B
    from volsurfs_tpu_torch.ops import shade as S
    from volsurfs_tpu_torch.renderers.mesh_renderer import camera_rays

    intr, poses = renderer.camera_tensors([camera])
    rays_o, rays_d = camera_rays(intr[0], poses[0], camera.width, camera.height)
    _, tri, u, v = B.trace_all_buffers(renderer.stacked_bvh, rays_o, rays_d,
                                       renderer.frame_cull([camera]))
    hits = S.hits_from_buffers(tri, u, v, renderer.nr_meshes)
    args = renderer.shade_inputs(hits, rays_d)[1:]
    out = S.shade_composite_buffers(tri, u, v, *args, width=camera.width)
    linear = S.shade_composite_buffers(tri, u, v, *args, width=0)
    ref, work = S._shade_composite_reference(hits, *args, return_work=True)
    renderer.stacked_bvh.check_step_cap()
    diffs = {key: (out[key] - ref[key]).abs() for key in ("rgb", "bg_transmittance")}
    max_abs = max(float(d.max()) for d in diffs.values())
    differ = {key: int((d > 0).sum()) for key, d in diffs.items()}
    finite = all(bool(torch.isfinite(out[key]).all()) for key in out)
    linear_equal = all(torch.equal(out[key], linear[key]) for key in out)
    tiled_fn = lambda: S.shade_composite_buffers(tri, u, v, *args, width=camera.width)  # noqa: E731
    linear_fn = lambda: S.shade_composite_buffers(tri, u, v, *args, width=0)  # noqa: E731
    ms = kb.time_ms(tiled_fn)
    # in the order tiled, linear, linear, tiled, so that the spread shows
    orders = {"tiled": tiled_fn, "linear": linear_fn}
    device = {"tiled": [], "linear": []}
    cold = {"tiled": [], "linear": []}
    for order in ("tiled", "linear", "linear", "tiled"):
        device[order].append(kb.device_ms(orders[order]))
        cold[order].append(kb.cold_ms(orders[order]))
    plain_ms = kb.time_ms(lambda: S._shade_composite_reference(hits, *args), reps=5, warmup=1)
    k, N = hits["is_hit"].shape
    # inputs read once: the face ids (4 B a shell and ray), u and v where
    # the id is a hit (8 B a hit), the directions of the rays that hit a
    # shell (a ray that hits none takes the background alone), the UVs of
    # the faces hit, the distinct texel bytes the hits need; rgb and T out
    nbytes = (4 * k * N + 8 * work["hits"] + 12 * work["rays_hit"] + 24 * work["faces_hit"]
              + work["texel_bytes"] + 16 * N)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, work["flops"] / F32_FLOPS_PER_S
    result = dict(
        scene=scene_name, shape=f"{scene_name}_{k}x{N}", shells=k, rays=N,
        sh_degree=renderer.sh_degree,
        texture_bytes=int(renderer.band_textures.texels.numel()), **work,
        hit_frac=work["hits"] / (k * N), max_abs_err=max_abs, entries_differ=differ,
        tolerance=K4_ATOL, width=camera.width, linear_equals_tiled=linear_equal,
        sass=sass.get(f"shade_composite_deg{renderer.sh_degree}_kernel"),
        ms=ms, device_ms=float(np.mean(device["tiled"])), device_ms_runs=device,
        cold_ms=float(np.mean(cold["tiled"])), cold_ms_runs=cold,
        plain_ms=plain_ms, library_ms=None,
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
    )
    emit("k4_shade", **result)
    if not finite or max_abs > K4_ATOL or not linear_equal:
        raise AssertionError(f"K4 disagrees with its plain version: {result}")
    return result


def phase_quality(renderer):
    """The committed scene's 4 test cameras at 256x256 through render_frame
    (culled) and render() in 65,536-ray chunks (unculled, as JAX's render)
    against the procedural ground truth; render() of camera 0 must equal
    render_rays of get_camera_rays' rays in one call."""
    from volsurfs_tpu_torch.datasets.baked_scene import committed_psnr_bar
    from volsurfs_tpu_torch.datasets.cameras import get_camera_rays
    from volsurfs_tpu_torch.datasets.mvdataset import MVDataset
    from volsurfs_tpu_torch.utils.evaluation import psnr

    res = 256
    test = MVDataset("synthetic", "sphere", "", splits=("test",),
                     config={"width": res, "height": res, "nr_test_cameras": 4})["test"]
    t = time.perf_counter()
    imgs = [renderer.render_frame(cam) for cam in test.cameras]
    secs = time.perf_counter() - t
    psnrs = [psnr(np.asarray(test.rgbs[i]), img) for i, img in enumerate(imgs)]
    traced = [renderer.render(cam, chunk_size=65536) for cam in test.cameras]
    render_psnrs = [psnr(np.asarray(test.rgbs[i]), img) for i, img in enumerate(traced)]
    rays_o, rays_d = (torch.from_numpy(x).to(renderer.device)
                      for x in get_camera_rays(test.cameras[0]))
    one_call = renderer.render_rays(rays_o, rays_d)["rgb"].reshape(res, res, 3).cpu().numpy()
    bar = committed_psnr_bar()
    result = dict(cameras=len(imgs), res=res, psnrs=psnrs, mean_psnr=float(np.mean(psnrs)),
                  bar=bar - 0.3, seconds=secs, render_psnrs=render_psnrs,
                  render_mean_psnr=float(np.mean(render_psnrs)),
                  render_equals_unculled_render_rays=bool(np.array_equal(traced[0], one_call)),
                  finite=bool(all(np.isfinite(img).all() for img in imgs + traced)))
    emit("baked_quality", **result)
    if not (result["finite"] and result["mean_psnr"] > bar - 0.3
            and result["render_equals_unculled_render_rays"]):
        raise AssertionError(f"baked replay failed: {result}")
    return result


def phase_orbit(renderer, smi, scene_info, scene_dir):
    """64 orbit frames at 800x800 through render_frames_device: best of 3
    runs, each queued whole and synced once; then two frames profiled in a
    fresh process (``orbit_profile``)."""
    cams = orbit_cameras(ORBIT_RES)
    imgs, overflow = renderer.render_frames_device(cams)  # warm-up
    torch.cuda.synchronize()
    if imgs.shape != (len(cams), ORBIT_RES, ORBIT_RES, 3) or not bool(torch.isfinite(imgs).all()):
        raise AssertionError(f"orbit: bad frames {tuple(imgs.shape)}")
    if int(overflow.abs().sum()):
        raise AssertionError(f"orbit: overflow {overflow.tolist()}")
    runs = []
    for _ in range(3):
        t = time.perf_counter()
        imgs, _ = renderer.render_frames_device(cams)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t)
    renderer.stacked_bvh.check_step_cap()
    rays = ORBIT_RES * ORBIT_RES * len(cams)
    hit = float((imgs[0] != 1.0).any(dim=-1).float().mean())
    result = dict(frames=len(cams), res=ORBIT_RES, rays=rays, run_s=runs,
                  mrays_per_s=rays / min(runs) / 1e6, frame_ms=min(runs) / len(cams) * 1e3,
                  non_background_frac=hit, card=smi, **scene_info)
    emit("baked_orbit", **result)
    # After the traces of the train path, torch.profiler loses a few events
    # of every frame in this process (35 of a frame's 38 kernels), so the
    # frame is profiled in a process that has traced nothing before.
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--orbit-profile", scene_dir],
        capture_output=True, text=True, timeout=300)
    if child.returncode != 0:
        raise AssertionError(f"orbit profile failed: {child.stderr[-3000:]}")
    emit("baked_orbit_profile", frames=2, card=smi, process="fresh",
         **json.loads(child.stdout.strip().splitlines()[-1]))
    if hit <= 0.0:
        raise AssertionError("orbit: no pixel of frame 0 hit a shell")
    return result


def orbit_profile(scene_dir):
    """The orbit's first frame of the scene in scene_dir, rendered once and
    then profiled twice through render_frames_device; prints profiled()'s
    line. Run by phase_orbit as ``chip_smoke.py --orbit-profile DIR``."""
    from volsurfs_tpu_torch.renderers.mesh_renderer import BakedMeshRenderer

    renderer = BakedMeshRenderer(scene_dir, device="cuda")
    cams = orbit_cameras(ORBIT_RES, 1)
    renderer.render_frames_device(cams)
    torch.cuda.synchronize()
    print(json.dumps(profiled(lambda: renderer.render_frames_device(cams), 2, top=None)),
          flush=True)


def phase_baked(device, smi, sass):
    """Phases 8-11: returns (K4's result at the full-width scene, the
    launches over phases 9-10)."""
    from volsurfs_tpu_torch.datasets import baked_scene
    from volsurfs_tpu_torch.datasets.mvdataset import MVDataset
    from volsurfs_tpu_torch.renderers.mesh_renderer import BakedMeshRenderer, camera_rays

    t = time.perf_counter()
    committed = BakedMeshRenderer(baked_scene.COMMITTED_SCENE, device=device)
    committed.stacked_bvh  # the lazy BVH build, counted in the load
    emit("baked_load", scene="committed", load_s=time.perf_counter() - t,
         texture_bytes=int(committed.band_textures.texels.numel()))
    scene_tmp = tempfile.TemporaryDirectory(prefix="vs_full_width_scene_")
    scene_dir = scene_tmp.name
    t = time.perf_counter()
    baked_scene.write_full_width_scene(scene_dir)
    write_s = time.perf_counter() - t
    t = time.perf_counter()
    full = BakedMeshRenderer(scene_dir, device=device)
    full.stacked_bvh  # the lazy BVH build, counted in the load
    load_s = time.perf_counter() - t
    scene_info = dict(scene="full_width", sh_degree=full.sh_degree,
                      textures_res=list(baked_scene.FULL_WIDTH_RES),
                      texture_bytes=int(full.band_textures.texels.numel()),
                      geometry="the 5 committed shells (not bench.py's bumpy spheres)",
                      write_s=write_s, load_s=load_s)
    emit("baked_load", **scene_info)

    test_cam = MVDataset("synthetic", "sphere", "", splits=("test",),
                         config={"width": 256, "height": 256, "nr_test_cameras": 4}
                         )["test"].cameras[0]
    orbit_cam = orbit_cameras(ORBIT_RES, 1)[0]
    phase_shade("committed", committed, test_cam, sass)  # the replay's shape
    phase_shade("full_width", full, orbit_cameras(256, 1)[0], sass)  # 5 x 65,536
    k4 = phase_shade("full_width", full, orbit_cam, sass)  # the orbit's shape
    # K2 at the orbit's frame shape (5 x 640,000 rays), culled as the orbit is
    intr, poses = full.camera_tensors([orbit_cam])
    check_trace(full.stacked_bvh, [(v, f) for v, f, _ in full.mesh_arrays],
                f"orbit_frame_5x{ORBIT_RES ** 2}",
                *camera_rays(intr[0], poses[0], orbit_cam.width, orbit_cam.height),
                cull=full.frame_cull([orbit_cam]))

    reset_counts()  # the baked render path: quality replay, then the orbit
    phase_quality(committed)
    phase_orbit(full, smi, scene_info, scene_dir)
    counts = read_counts()
    scene_tmp.cleanup()
    emit("baked_launches", **counts)
    return k4, counts


def _permuto_backward_cost(n, L, rows_read, total_rows, grads, points):
    """Bytes and operations of the fused backward: the points, the
    cotangents, the gradient's memset and one more 8-byte write of each
    distinct row its updates touch; with the points' gradient the distinct
    table rows read and 12 B a point out. ~90 flops a (point, level) to
    recompute the simplex, ~8 a (point, level, corner) for an update, 15
    more with grads, 12 more for the points' gradient."""
    nl = n * L
    nbytes = 12 * n + nl * (8 + (24 if grads else 0)) + 8 * total_rows + 8 * rows_read
    flops = nl * 90 + nl * 4 * (8 + (15 if grads else 0))
    if points:
        nbytes += 8 * rows_read + 12 * n
        flops += nl * 4 * 12
    return nbytes, flops


def _bound(nbytes, flops, ops_per_s=F32_FLOPS_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_permuto(device, resources):
    """K6 against its plain versions at the surf stage's shapes: a data
    step's 512 x 96 samples (with grads and the points' gradient, the
    curvature term's SDF lookup; without grads, the colour field's), a
    sphere-init step's 30,000 points and an occupancy-refresh chunk of
    65,536 (no backward follows). The forward's feats and dfeats equal its
    plain version's bit for bit; the fused backward's points' gradient too,
    and its table gradient lies within the atomics' summation error of
    permuto_backward_reference + scatter_add_rows_reference. At the
    curvature shape also K1 on the per-corner updates (the design the fused
    backward replaced) beside index_add_."""
    from volsurfs_tpu_torch import kernel_bench as kb
    from volsurfs_tpu_torch.ops import permuto as P
    from volsurfs_tpu_torch.ops import scatter_add as S

    results = {}
    # case, points, with grads, a backward follows, the points' gradient
    for case, n, grads, bwd, points in (("data_step", 49152, True, True, True),
                                        ("data_step", 49152, False, True, False),
                                        ("sphere_init", 30000, True, True, False),
                                        ("refresh_chunk", 65536, False, False, False)):
        enc, unit, rng = kb.k6_inputs(device, n)
        n, L, R = unit.shape[0], enc.nr_levels, enc.total_rows
        ddiff = enc.ddiff if grads else None
        table = enc.table.detach()
        args = (unit, table, enc.W, enc.level_sizes, enc.level_offsets, ddiff)
        ref = P.permuto_forward_reference(*args)
        got = P.permuto_forward(*args)
        differ = {name: int((a != b).sum()) for name, a, b in
                  zip(("feats", "dfeats"), got, ref[:2]) if a is not None}
        idx, bary, code = ref[2:]
        rows_read = int(torch.unique(idx).numel())  # the rows the points touch, for the bounds
        nl = n * L
        # forward: points in, the distinct rows read; feats (and dfeats with
        # grads) out; ~90 flops a (point, level), 60 more for the Jacobian
        fwd_bytes = 12 * n + 8 * rows_read + nl * (8 + (24 if grads else 0))
        fwd_flops = nl * (90 + (60 if grads else 0))
        timed = [("fwd_", lambda: P.permuto_forward(*args),
                  lambda: P.permuto_forward_reference(*args, save=False),
                  _bound(fwd_bytes, fwd_flops))]
        row = dict(points=n, grads=grads, rows_read=rows_read)
        if bwd:
            dout = torch.from_numpy(rng.standard_normal((n, 2 * L)).astype(np.float32)).to(device)
            gd = (torch.from_numpy(rng.standard_normal((3, n, 2 * L)).astype(np.float32))
                  .to(device) if grads else None)
            bargs = (unit, table, enc.W, enc.level_sizes, enc.level_offsets, dout, ddiff, gd)
            d_table, d_unit = P.permuto_backward(*bargs, want_unit=points)
            d_ref, d_unit_ref = P.permuto_backward_fused_reference(*bargs, want_unit=points)
            upd, _ = P.permuto_backward_reference(idx, bary, code, dout, ddiff, gd)
            rows = idx.reshape(-1)
            err = (d_table - d_ref).abs()
            # the atomics sum a row's updates in another order: 1e-5 of
            # their absolute sum
            tol = 1e-5 * S.scatter_add_rows_reference(rows, upd.abs(), R) + 1e-6
            row["d_table_max_abs_err"] = float(err.max())
            if not bool((err <= tol).all()):
                raise AssertionError(f"K6 {case} (grads {grads}): d_table err {float(err.max())}")
            if points:
                differ["d_unit"] = int((d_unit != d_unit_ref).sum())
            timed.append(("bwd_", lambda: P.permuto_backward(*bargs, want_unit=points),
                          lambda: P.permuto_backward_fused_reference(*bargs, want_unit=points),
                          _bound(*_permuto_backward_cost(n, L, rows_read, R, grads, points))))
        if any(differ.values()):
            raise AssertionError(f"K6 {case} (grads {grads}): entries differ {differ}")
        row["entries_differ"] = differ
        for prefix, fn, plain, (bound_ms, bound_by) in timed:
            row.update({prefix + "ms": kb.time_ms(fn), prefix + "device_ms": kb.device_ms(fn),
                        prefix + "plain_ms": kb.time_ms(plain, reps=5, warmup=1),
                        prefix + "bound_ms": bound_ms, prefix + "bound_by": bound_by})
        if points:
            row["k1_surf_shape"] = _k1_at_the_surf_shape(idx.reshape(-1), upd, R)
        row["registers"] = {k: v.get("registers") for k, v in resources.items()
                            if k.startswith("permuto_")}
        results[(case, grads)] = row
        emit("k6_permuto", case=case, **row)
        del enc
    return results[("data_step", True)]


def _k1_at_the_surf_shape(rows, upd, nr_rows):
    """K1 on the curvature lookup's per-corner updates, the scatter of the
    design the fused backward replaced (4,718,592 updates into 3,898,240
    rows), with its plain version and index_add_."""
    from volsurfs_tpu_torch import kernel_bench as kb
    from volsurfs_tpu_torch.ops import scatter_add as S

    m = rows.shape[0]
    k1 = {"updates": m, "rows": nr_rows}
    for prefix, fn in (("", lambda: S.scatter_add_rows(rows, upd, nr_rows)),
                       ("library_", lambda: torch.zeros(nr_rows, 2, device=upd.device)
                        .index_add_(0, rows, upd))):  # yardstick only: the port never calls it
        k1[prefix + "ms"] = kb.time_ms(fn)
        k1[prefix + "device_ms"] = kb.device_ms(fn)
    k1["plain_ms"] = kb.time_ms(lambda: S.scatter_add_rows_reference(rows, upd, nr_rows), reps=5,
                                warmup=1)
    # K1's bound, as phase 3 counts it: rows and updates read, table written
    k1["bound_ms"], k1["bound_by"] = _bound(4 * m + 8 * m + 8 * nr_rows, 2 * m)
    return k1


def _voxels_read(grid, rays_o, rays_d, spans, nr_steps=512):
    """The distinct voxels that the probes and the march of each (t0, t1)
    span read (steps of zero length read none)."""
    ids = []
    k = torch.arange(nr_steps, dtype=torch.float32, device=rays_o.device)[None, :]
    for t0, t1 in spans:
        seg = (t1 - t0) / nr_steps
        pts = rays_o[:, None] + (t0 + (k + 0.5) * seg)[..., None] * rays_d[:, None]
        coords, inb = grid.pos_to_voxel_idx(pts.reshape(-1, 3))
        keep = inb & (seg > 0).expand(-1, nr_steps).reshape(-1)
        c = coords.long()[keep]
        ids.append((c[:, 0] * grid.res + c[:, 1]) * grid.res + c[:, 2])
    return int(torch.unique(torch.cat(ids)).numel())


def phase_occupancy_sampler(device, reel):
    """K7 against its plain version on a refreshed 256^3 grid: a train
    step's 512 rays (drawn from the train reel), the 2,048 and 4,096 of the
    offsets_surfs steps' buckets, and a 16,384-ray render chunk of the test
    camera, clipped to the occupied probes as base.cfg
    samples (64 a ray; kernel_bench.k7_cases): z, mask, the clipped
    interval and the spacing bit for bit. The bound: the distinct voxels
    read and the rays' bytes, and the operations of the points of both
    passes on rays whose step is not 0 (K7_OPS_A_POINT a point) at the
    card's issue rate."""
    from volsurfs_tpu_torch import kernel_bench as kb
    from volsurfs_tpu_torch.ops import samplers as SP

    results = {}
    cases = kb.k7_cases(device, reel, kb.k7_grid(device), train_rays=kb.K7_TRAIN_RAYS)
    for shape, args in cases.items():
        o, d, tn, tf, grid = args[:5]
        got, ref = SP.occupancy_samples(*args), SP.occupancy_samples_reference(*args)
        differ = {name: int((a != b).sum()) for name, a, b in
                  zip(("z", "mask", "t_near", "t_far", "const_dist"), got, ref)}
        if any(differ.values()):
            raise AssertionError(f"K7 {shape}: entries differ {differ}")
        R = o.shape[0]
        voxels = _voxels_read(grid, o, d, ((tn, tf), (got[2], got[3])))
        nbytes = R * (12 + 12 + 4 + 4 + 4) + voxels + R * 64 * (4 + 1) + R * 12
        # the points of the probe (rays with tf > tn) and of the march
        # (rays whose clipped interval is not empty)
        points = 512 * (int((tf > tn).sum()) + int((got[3] > got[2]).sum()))
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, points * K7_OPS_A_POINT / ISSUE_PER_S
        fn = lambda: SP.occupancy_samples(*args)  # noqa: E731
        results[shape] = dict(
            shape=shape, rays=R, samples=int(got[1].sum()), voxels_read=voxels,
            points=points, ops_a_point=K7_OPS_A_POINT, entries_differ=differ, max_abs_err=0.0,
            ms=kb.time_ms(fn), device_ms=kb.device_ms(fn),
            plain_ms=kb.time_ms(lambda: SP.occupancy_samples_reference(*args), reps=5, warmup=1),
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None)
        emit("k7_occupancy_sampler", **results[shape])
    return results[f"train_{kb.TRAIN_RAYS}"]


def surf_hyper_params():
    """config/surf/base.cfg at its full width, its schedule cut by one
    factor (1/50): 100 sphere-init steps (5000), warmup 60 (3000), the SDF's
    coarse-to-fine 100 (5000), the first phase's end 2000 (100000),
    milestones 1600 and 1800 (80000, 90000); and the run cut to
    SURF_SPHERE_STEPS + SURF_DATA_STEPS steps. Returns (hp, the cuts)."""
    from volsurfs_tpu_torch.params.hyper_params import get_method_hyper_params

    hp = get_method_hyper_params("surf", SURF_CFG)
    scale = SURF_SPHERE_STEPS / hp.init_phase_end_iter
    cuts = {}
    for name in ("init_phase_end_iter", "nr_warmup_iters", "sdf_nr_iters_for_c2f",
                 "first_phase_end_iter"):
        cuts[name] = [getattr(hp, name), round(getattr(hp, name) * scale)]
        setattr(hp, name, cuts[name][1])
    cuts["lr_milestones"] = [list(hp.lr_milestones), [round(m * scale) for m in hp.lr_milestones]]
    hp.lr_milestones = cuts["lr_milestones"][1]
    cuts["training_end_iter"] = [hp.training_end_iter, SURF_SPHERE_STEPS + SURF_DATA_STEPS]
    hp.training_end_iter = cuts["training_end_iter"][1]
    return hp, cuts


def make_surf(hp, device, seed, bg_color="white"):
    from volsurfs_tpu_torch.methods.surf import Surf
    from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere

    return Surf(hp, make_bounding_sphere(1.0), bg_color=bg_color, occupancy_res=256,
                device=device, seed=seed)


def phase_surf_train(device, mv, run_dir, bg_color="white", prefix="surf"):
    """The surf stage's training through Trainer.train (phase 14; with the
    trained background, phase 24): the median step time of each phase, the
    occupancy refreshes and the occupied fraction after each. Its lines'
    phases begin with prefix. Returns the trainer."""
    from volsurfs_tpu_torch.params.params import TrainParams
    from volsurfs_tpu_torch.training import callbacks as CB
    from volsurfs_tpu_torch.training.trainer import Trainer

    hp, cuts = surf_hyper_params()
    t = time.perf_counter()
    method = make_surf(hp, device, seed=0, bg_color=bg_color)
    timer = CB.StepTimerCallback(device)
    trainer = Trainer(method, mv, run_dir, log_every=50, seed=0,
                      train_params=TrainParams("surf", TRAIN_CFG),
                      callbacks=CB.CallbacksGroup([timer]))
    refreshes = []
    refresh = method.update_occupancy_grid

    def recorded_refresh():
        refresh()
        refreshes.append([method.iter_nr, float(method.grid.occupancy_fraction())])

    method.update_occupancy_grid = recorded_refresh
    emit(prefix + "_setup", setup_s=time.perf_counter() - t, cuts=cuts,
         params={k: sum(p.numel() for p in m.parameters()) for k, m in method.models.items()},
         rays_per_step=hp.training_rays_batch_size, lr=hp.lr)
    buckets = []
    t = time.perf_counter()
    trainer.train(callback=lambda it, m, losses: buckets.append(trainer._rays_bucket))
    train_s = time.perf_counter() - t
    del method.update_occupancy_grid
    losses = timer.losses()
    n_init = hp.init_phase_end_iter
    init, data = losses[:n_init], losses[n_init:]
    step_ms = np.asarray(timer.step_ms)
    result = dict(
        steps=len(losses), train_s=train_s,
        sphere_init=dict(steps=len(init), first_10=float(init[:10].mean()),
                         last_10=float(init[-10:].mean()),
                         median_step_ms=float(np.median(step_ms[5:n_init]))),
        data=dict(steps=len(data), first_10=float(data[:10].mean()),
                  last_10=float(data[-10:].mean()),
                  median_step_ms=float(np.median(step_ms[n_init + 5:]))),
        refreshes=refreshes, rays_bucket_by_step=buckets[::25],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit(prefix + "_train", **result)
    if not np.isfinite(losses).all():
        raise AssertionError(f"{prefix}: losses not finite: {losses.tolist()}")
    if not result["sphere_init"]["last_10"] < result["sphere_init"]["first_10"] or not refreshes:
        raise AssertionError(f"{prefix}: the sphere-init loss did not fall or no refresh: "
                             f"{result}")
    return trainer


def phase_surf_stage(device, trainer, chunk, prefix="surf", bar=SURF_PSNR_BAR, profile=True):
    """The rest of the surf stage (phase 15; with the trained background,
    phase 25): the checkpoint round trip (a fresh Surf, other seed, renders
    test camera 0 bit for bit alike), eval_split of the test split (psnr >
    bar) and, with profile, 3 profiled data steps. Its lines' phases begin
    with prefix. Returns the evaluation's means."""
    from volsurfs_tpu_torch.training import checkpoints
    from volsurfs_tpu_torch.training.trainer import Trainer

    method, mv, run_dir = trainer.method, trainer.mv_data, trainer.run_dir
    cam = mv["test"].cameras[0]
    t = time.perf_counter()
    path = trainer.save_checkpoint()
    sync(device)
    save_s = time.perf_counter() - t
    fresh = make_surf(method.hp, device, seed=1,
                      bg_color="trained" if "bg" in method.models else "white")
    checkpoints.load_checkpoint(trainer.ckpt_dir, fresh)
    reloaded = Trainer(fresh, mv, os.path.join(run_dir, "reloaded"))
    ref = trainer.render_camera(cam, chunk)["rgb"]
    got = reloaded.render_camera(cam, chunk)["rgb"]
    result = dict(iter_nr=fresh.iter_nr, files=sorted(os.listdir(path)), bytes=dir_bytes(path),
                  save_s=save_s, render_equal=bool(np.array_equal(got, ref)),
                  max_abs_diff=float(np.abs(got - ref).max()),
                  grid_equal=bool(torch.equal(fresh.grid.occupied, method.grid.occupied)))
    emit(prefix + "_checkpoint", **result)
    if not (result["render_equal"] and result["grid_equal"]) or fresh.iter_nr != method.iter_nr:
        raise AssertionError(f"{prefix} checkpoint round trip differs: {result}")
    del fresh, reloaded

    t = time.perf_counter()
    means = trainer.eval_split("test", chunk_size=chunk)
    emit(prefix + "_eval", split="test", cameras=len(mv["test"].cameras),
         seconds=time.perf_counter() - t, bar_psnr=bar, **means)
    if not means["psnr"] > bar:
        raise AssertionError(f"{prefix}: test psnr {means['psnr']} <= {bar}")
    if profile:
        PROFILES[prefix] = profiled(trainer.train_iteration, PROFILED_STEPS)
        emit(prefix + "_train_profile", steps=PROFILED_STEPS, rays=trainer._rays_bucket,
             **PROFILES[prefix])
    return means


def phase_surf(device, reel, mv, resources):
    """The surf stage (phases 12-15): K6 and K7 against their plain
    versions, then the main path surf_stage with the counts reset. Returns
    (K6's result, K7's, the path's launches, the checkpointed SDF's state
    dict, the rays of its last step)."""
    k6 = phase_permuto(device, resources)
    k7 = phase_occupancy_sampler(device, reel)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run_tmp = tempfile.TemporaryDirectory(prefix="vs_surf_run_")
    reset_counts()  # the main path surf_stage: train, checkpoint, evaluate, profile
    trainer = phase_surf_train(device, mv, run_tmp.name)
    phase_surf_stage(device, trainer, CHUNK_SURF)
    counts = read_counts()
    emit("surf_stage_launches", **counts)
    # the stage's product for the next: the checkpointed SDF
    from volsurfs_tpu_torch.training.checkpoints import get_last_checkpoint_in_path

    last = get_last_checkpoint_in_path(trainer.ckpt_dir)
    sdf_path = os.path.join(trainer.ckpt_dir, f"{last:07d}", "models", "sdf.pt")
    sdf_state = torch.load(sdf_path, map_location="cpu", weights_only=True)
    rays = trainer._rays_bucket
    del trainer
    run_tmp.cleanup()
    torch.cuda.empty_cache()
    return k6, k7, counts, sdf_state, rays


def _k8_cost(kind, args):
    """(bytes, operations) of one K8 call: each input read once, each output
    written once; a few operations a sample (combine: ~6 a slot for the
    merge, the chain and dt; the scan: 4 a sample forward, 8 backward;
    importance: ~40 a sample and surface for the alphas, scan, weights and
    CDF, 2 log2(S) + 12 a new depth)."""
    if kind == "combine":
        a, b, va, _ = args
        R, Sa = a.z.shape
        S, C = Sa + b.z.shape[1], 0 if va is None else va.shape[-1]
        return R * (S * (5 + 4 * C) + 12) + R * (S * (9 + 4 * C) + 4), 6 * R * S
    if kind in ("transmittance_fwd", "transmittance_bwd"):
        N, S = args[0].shape
        if kind == "transmittance_fwd":
            return N * S * 5 + N * S * 8 + 4 * N, 4 * N * S
        return N * S * 17 + 4 * N + 4 * N * S, 8 * N * S
    samples, sdfs, _, n, _ = args
    R, S = samples.z.shape
    K = sdfs.shape[-1]
    nbytes = R * S * (9 + 4 * K) + R * n * 4 + R * n * 5
    return nbytes, R * S * K * 40 + R * n * (2 * int(np.log2(S)) + 12)


def phase_volrender(device, resources, cases):
    """K8 against its plain versions at each case {name: (K, R)}: the surf
    (K = 1) and offsets_surfs (K = 5) data steps' shapes at the rays R
    their paths' last steps took, and the surf eval chunk's (phase 18).
    Returns {name: {kernel: result}} of each kernel's last case."""
    from volsurfs_tpu_torch import kernel_bench as kb
    from volsurfs_tpu_torch.ops import samples as TS
    from volsurfs_tpu_torch.ops import volume_rendering as VR

    registers = {k: v.get("registers") for k, v in resources.items()
                 if k.startswith(("combine_samples", "neus_"))}
    results = {}
    for name, (K, R) in cases.items():
        inputs = kb.k8_cases(device, K, R)
        rows = {}

        def measure(kernel, case, kind, fn, plain, args, got, ref, library=None):
            check = kb.k8_check(kind, got, ref)
            bound_ms, bound_by = _bound(*_k8_cost(kind, args))
            row = dict(kernel=kernel, path=name, surfaces=K, rays=R, case=case, **check,
                       ms=kb.time_ms(fn),
                       device_ms=kb.device_ms(fn),
                       plain_ms=kb.time_ms(plain, reps=5, warmup=1), bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=None if library is None else
                       kb.time_ms(library), registers=registers)
            emit("k8_volrender", **row)
            if not check["ok"]:
                raise AssertionError(f"K8 {kernel} ({name}, {case}) disagrees: {row}")
            rows[kernel] = row

        for merge, args in inputs["combine"].items():
            a, b, va, vb = args
            got, ref = TS.combine(*args[:2], 1e-4, va, vb), TS.combine_reference(a, b, 1e-4, va, vb)
            outs = [(s_.z, s_.mask, s_.dt, s_.max_dt) + (() if v is None else (v,))
                    for s_, v in (got, ref)]
            measure("combine_samples", merge, "combine",
                    lambda: TS.combine(a, b, 1e-4, va, vb),
                    lambda: TS.combine_reference(a, b, 1e-4, va, vb), args, *outs)
        alpha, mask = inputs["transmittance"]
        cot = [torch.randn(alpha.shape, device=device), torch.randn(alpha.shape, device=device),
               torch.randn(alpha.shape[0], 1, device=device)]
        graphs = {}
        for side, fn in (("kernel", VR.neus_transmittance),
                         ("plain", VR.neus_transmittance_reference)):
            a = alpha.clone().requires_grad_(True)
            out = fn(a, mask)
            graphs[side] = (a, out)
        outs = [tuple(o.detach() for o in graphs[n][1]) for n in ("kernel", "plain")]
        shape = f"{alpha.shape[0]}x{alpha.shape[1]}"
        measure("neus_transmittance_forward", shape, "transmittance_fwd",
                lambda: VR.neus_transmittance(alpha, mask),
                lambda: VR.neus_transmittance_reference(alpha, mask), (alpha,), *outs,
                library=lambda: torch.cumprod(alpha, dim=1))  # yardstick only

        def backward(side):
            a, out = graphs[side]
            return torch.autograd.grad(out, a, cot, retain_graph=True)

        grads = [backward(n) for n in ("kernel", "plain")]
        measure("neus_transmittance_backward", shape, "transmittance_bwd",
                lambda: backward("kernel"), lambda: backward("plain"), (alpha,), *grads)
        for rnd, args in inputs["importance"].items():
            got, ref = VR.neus_importance(*args), VR.neus_importance_reference(*args)
            measure("neus_importance", f"{rnd}_samples", "importance",
                    lambda: VR.neus_importance(*args),
                    lambda: VR.neus_importance_reference(*args), args,
                    (got.z, got.mask), (ref.z, ref.mask))
        results[name] = rows
    return results


def offsets_hyper_params():
    """config/offsets_surfs/base_5.cfg at its full width, its schedule cut by
    one factor (OFFSETS_SCALE) but for the offsets-init phase
    (OFFSETS_INIT_STEPS): the phases' ends (2000, 3000, 45000), the warmup
    (1000), the milestones (40000, 45000, 47500) and the run (50000), each
    end after the offsets-init phase's moved by the steps that phase gained
    over the cut. Returns (hp, the cuts)."""
    from volsurfs_tpu_torch.params.hyper_params import get_method_hyper_params

    hp = get_method_hyper_params("offsets_surfs", OFFSETS_CFG)
    shift = OFFSETS_INIT_STEPS - round(hp.init_phase_end_iter * OFFSETS_SCALE)
    cuts = {}
    for name in ("init_phase_end_iter", "color_init_phase_end_iter", "first_phase_end_iter",
                 "nr_warmup_iters", "training_end_iter"):
        moved = 0 if name == "nr_warmup_iters" else shift
        cuts[name] = [getattr(hp, name), round(getattr(hp, name) * OFFSETS_SCALE) + moved]
        setattr(hp, name, cuts[name][1])
    cuts["lr_milestones"] = [list(hp.lr_milestones),
                             [round(m * OFFSETS_SCALE) + shift for m in hp.lr_milestones]]
    hp.lr_milestones = cuts["lr_milestones"][1]
    if hp.clip_rays_to_occupancy != OFFSETS_CLIP_TO_OCCUPANCY:
        cuts["clip_rays_to_occupancy"] = [hp.clip_rays_to_occupancy, OFFSETS_CLIP_TO_OCCUPANCY]
        hp.clip_rays_to_occupancy = OFFSETS_CLIP_TO_OCCUPANCY
    return hp, cuts


def make_offsets(hp, device, seed):
    from volsurfs_tpu_torch.methods.offsets_surfs import OffsetsSurfs
    from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere

    return OffsetsSurfs(hp, make_bounding_sphere(1.0), bg_color="white", occupancy_res=256,
                        device=device, seed=seed)


def phase_offsets_train(device, mv, run_dir, sdf_state):
    """The offsets_surfs stage's training through Trainer.train from the surf
    stage's SDF (phase 16): each phase's median step and losses; the
    occupancy refreshes, each with its step, the grid's occupied share
    after it, the variance and logistic beta it took and the last step's
    loss. Returns the trainer."""
    from volsurfs_tpu_torch.params.params import TrainParams
    from volsurfs_tpu_torch.training import callbacks as CB
    from volsurfs_tpu_torch.training.trainer import Trainer
    from volsurfs_tpu_torch.utils.schedules import get_logistic_beta_from_variance

    hp, cuts = offsets_hyper_params()
    t = time.perf_counter()
    method = make_offsets(hp, device, seed=0).load_main_sdf(sdf_state)
    timer = CB.StepTimerCallback(device)
    trainer = Trainer(method, mv, run_dir, log_every=50, seed=0,
                      train_params=TrainParams("offsets_surfs", TRAIN_CFG),
                      callbacks=CB.CallbacksGroup([timer]))
    refreshes = []
    refresh = method.update_occupancy_grid
    last_loss = [float("nan")]

    def recorded_refresh():
        refresh()
        # the variance and beta update_occupancy_grid took
        variance = min(0.8, float(method._variance(method.iter_nr)))
        refreshes.append([method.iter_nr, float(method.grid.occupancy_fraction()), variance,
                          float(get_logistic_beta_from_variance(variance)), last_loss[0]])

    method.update_occupancy_grid = recorded_refresh
    # the variance schedule under the cut: 0.7 at color-init's end to 1.0 at
    # the first phase's; the refresh's capped at 0.8
    variance = dict(start_iter=hp.color_init_phase_end_iter, end_iter=hp.first_phase_end_iter,
                    start=hp.first_phase_variance_start_value,
                    end=hp.first_phase_variance_end_value,
                    refresh_cap_0_8_at_iter=next(
                        (i for i in range(hp.training_end_iter + 1)
                         if method._variance(i) >= np.float32(0.8)), None))
    emit("offsets_setup", setup_s=time.perf_counter() - t, cuts=cuts, scale=OFFSETS_SCALE,
         offsets_init_steps=OFFSETS_INIT_STEPS,
         variance_schedule=variance, surfaces=method.nr_surfs,
         main_surf_idx=method.main_surf_idx, delta_surfs=method.delta_surfs,
         params={k: sum(p.numel() for p in m.parameters()) for k, m in method.models.items()},
         rays_per_step=hp.training_rays_batch_size, lr=hp.lr)
    phases, buckets, rgb = [], [], []

    def log(it, m, losses):
        # the timer has synchronised: reading the rgb loss costs no wait
        phases.append(m.phase(it - 1))
        buckets.append(trainer._rays_bucket)
        rgb.append(float(losses["rgb"]) if "rgb" in losses else float("nan"))
        last_loss[0] = float(losses["loss"])

    t = time.perf_counter()
    trainer.train(callback=log)
    train_s = time.perf_counter() - t
    del method.update_occupancy_grid
    losses, step_ms = timer.losses(), np.asarray(timer.step_ms)
    by_phase = {}
    for name in ("offsets_init", "color_init", "first", "second"):
        idx = np.asarray([i for i, p in enumerate(phases) if p == name])
        timed = idx[2:] if len(idx) > 4 else idx  # the first steps of a phase compile nothing
        by_phase[name] = dict(steps=len(idx), first=float(losses[idx[0]]),
                              last=float(losses[idx[-1]]),
                              mean_first_5=float(losses[idx[:5]].mean()),
                              mean_last_5=float(losses[idx[-5:]].mean()),
                              rgb_mean_last_5=float(np.mean(np.asarray(rgb)[idx[-5:]])),
                              median_step_ms=float(np.median(step_ms[timed])))
    # the largest fall of the occupied share from one refresh to the next
    falls = [(b[1] / a[1], a[0], b[0]) for a, b in zip(refreshes, refreshes[1:]) if a[1] > 0]
    result = dict(steps=len(losses), train_s=train_s, phases=by_phase, refreshes=refreshes,
                  largest_refresh_fall=min(falls, default=None),
                  rays_bucket_by_step=buckets[::25],
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("offsets_train", **result)
    if not np.isfinite(losses).all():
        raise AssertionError(f"offsets_surfs: losses not finite: {losses.tolist()}")
    init = by_phase["offsets_init"]
    if not init["mean_last_5"] < init["mean_first_5"] or min(
            p["steps"] for p in by_phase.values()) < 10 or not refreshes:
        raise AssertionError(f"offsets_surfs: a phase short, the offsets-init loss did not "
                             f"fall or no refresh: {result}")
    return trainer


def phase_offsets_stage(device, trainer, chunk):
    """The rest of the offsets_surfs stage (phase 17): the checkpoint round
    trip (a fresh OffsetsSurfs, other seed, renders test camera 0's rgb and
    surfaces' opacities bit for bit alike), eval_split of the test split
    and 3 profiled data steps."""
    from volsurfs_tpu_torch.training import checkpoints
    from volsurfs_tpu_torch.training.trainer import Trainer

    method, mv, run_dir = trainer.method, trainer.mv_data, trainer.run_dir
    cam = mv["test"].cameras[0]
    t = time.perf_counter()
    path = trainer.save_checkpoint()
    sync(device)
    save_s = time.perf_counter() - t
    fresh = make_offsets(method.hp, device, seed=1)
    checkpoints.load_checkpoint(trainer.ckpt_dir, fresh)
    reloaded = Trainer(fresh, mv, os.path.join(run_dir, "reloaded"))
    ref = trainer.render_camera(cam, chunk)
    got = reloaded.render_camera(cam, chunk)
    result = dict(iter_nr=fresh.iter_nr, files=sorted(os.listdir(path)), bytes=dir_bytes(path),
                  save_s=save_s, outputs={k: list(v.shape) for k, v in got.items()},
                  render_equal=all(np.array_equal(got[k], ref[k]) for k in ref),
                  max_abs_diff=max(float(np.abs(got[k] - ref[k]).max()) for k in ref),
                  grid_equal=bool(torch.equal(fresh.grid.occupied, method.grid.occupied)))
    emit("offsets_checkpoint", **result)
    if (not (result["render_equal"] and result["grid_equal"]) or fresh.iter_nr != method.iter_nr
            or got["surfs_alpha"].shape != (cam.height, cam.width, method.nr_surfs)):
        raise AssertionError(f"offsets_surfs checkpoint round trip differs: {result}")
    del fresh, reloaded

    t = time.perf_counter()
    means = trainer.eval_split("test", chunk_size=chunk)
    emit("offsets_eval", split="test", cameras=len(mv["test"].cameras),
         seconds=time.perf_counter() - t, bar_psnr=OFFSETS_PSNR_BAR, **means)
    if not means["psnr"] > OFFSETS_PSNR_BAR:
        raise AssertionError(f"offsets_surfs: test psnr {means['psnr']} <= {OFFSETS_PSNR_BAR}")
    emit("offsets_train_profile", steps=PROFILED_STEPS, rays=trainer._rays_bucket,
         train_phase=method.phase(method.iter_nr),
         **profiled(trainer.train_iteration, PROFILED_STEPS, top=8))
    return means


def phase_offsets(device, mv, sdf_state):
    """The main path offsets_stage (phases 16-17), with the counts reset.
    Returns (its launches, the rays of its last step, the trained
    method)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run_tmp = tempfile.TemporaryDirectory(prefix="vs_offsets_run_")
    reset_counts()  # the main path offsets_stage: train, checkpoint, evaluate, profile
    trainer = phase_offsets_train(device, mv, run_tmp.name, sdf_state)
    phase_offsets_stage(device, trainer, CHUNK_SURF)
    counts = read_counts()
    emit("offsets_stage_launches", **counts)
    rays, method = trainer._rays_bucket, trainer.method
    del trainer
    run_tmp.cleanup()
    torch.cuda.empty_cache()
    return counts, rays, method


def nerf_hyper_params(scale=NERF_SCALE):
    """config/nerf/base.cfg at its full width, its schedule cut by one
    factor: the run (200000), the warmup (3000), the density's
    coarse-to-fine (1000) and the milestones (100000, 150000, 180000,
    190000). Returns (hp, the cuts)."""
    from volsurfs_tpu_torch.params.hyper_params import get_method_hyper_params

    hp = get_method_hyper_params("nerf", NERF_CFG)
    cuts = {}
    for name in ("training_end_iter", "nr_warmup_iters", "density_nr_iters_for_c2f"):
        cuts[name] = [getattr(hp, name), max(1, round(getattr(hp, name) * scale))]
        setattr(hp, name, cuts[name][1])
    cuts["lr_milestones"] = [list(hp.lr_milestones), [round(m * scale) for m in hp.lr_milestones]]
    hp.lr_milestones = cuts["lr_milestones"][1]
    return hp, cuts


def make_nerf(hp, device, seed):
    from volsurfs_tpu_torch.methods.nerf import NeRF
    from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere

    return NeRF(hp, make_bounding_sphere(1.0), bg_color="white", occupancy_res=256,
                device=device, seed=seed)


def phase_nerf_train(device, mv, run_dir, scale=NERF_SCALE):
    """The nerf stage's training through Trainer.train (phase 21): the
    median step time, the loss, the occupancy refreshes (every 50 steps)
    with the occupied share after each and their seconds. Returns the
    trainer."""
    from volsurfs_tpu_torch.methods.nerf import NeRF
    from volsurfs_tpu_torch.params.params import TrainParams
    from volsurfs_tpu_torch.training import callbacks as CB
    from volsurfs_tpu_torch.training.trainer import Trainer

    hp, cuts = nerf_hyper_params(scale)
    t = time.perf_counter()
    method = make_nerf(hp, device, seed=0)
    timer = CB.StepTimerCallback(device)
    trainer = Trainer(method, mv, run_dir, log_every=100, seed=0,
                      train_params=TrainParams("nerf", TRAIN_CFG),
                      callbacks=CB.CallbacksGroup([timer]))
    refreshes = []
    refresh = method.update_occupancy_grid

    def recorded_refresh():
        t0 = time.perf_counter()
        refresh()
        share = float(method.grid.occupancy_fraction())  # syncs
        refreshes.append([method.iter_nr, share, time.perf_counter() - t0])

    method.update_occupancy_grid = recorded_refresh
    emit("nerf_setup", setup_s=time.perf_counter() - t, cuts=cuts, scale=scale,
         sparsity_start_iter=NeRF.sparsity_start_iter,
         params={k: sum(p.numel() for p in m.parameters()) for k, m in method.models.items()},
         rays_per_step=hp.training_rays_batch_size, samples=[hp.max_nr_samples_per_ray,
                                                             hp.max_nr_imp_samples_per_ray],
         lr=hp.lr)
    buckets = []
    t = time.perf_counter()
    trainer.train(callback=lambda it, m, losses: buckets.append(trainer._rays_bucket))
    train_s = time.perf_counter() - t
    del method.update_occupancy_grid
    losses, step_ms = timer.losses(), np.asarray(timer.step_ms)
    result = dict(steps=len(losses), train_s=train_s, first_10=float(losses[:10].mean()),
                  last_10=float(losses[-10:].mean()),
                  median_step_ms=float(np.median(step_ms[5:])), refreshes=refreshes,
                  rays_bucket_by_step=buckets[::25],
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("nerf_train", **result)
    if not np.isfinite(losses).all():
        raise AssertionError(f"nerf: losses not finite: {losses.tolist()}")
    if not result["last_10"] < result["first_10"] or not refreshes:
        raise AssertionError(f"nerf: the loss did not fall or no refresh: {result}")
    return trainer


def phase_nerf_stage(device, trainer, chunk, profile=True):
    """The rest of the nerf stage (phase 22): the checkpoint round trip (a
    fresh NeRF, other seed, renders test camera 0 bit for bit alike),
    eval_split of the test split and, with profile, 3 profiled steps.
    Returns the evaluation's means."""
    from volsurfs_tpu_torch.training import checkpoints
    from volsurfs_tpu_torch.training.trainer import Trainer

    method, mv, run_dir = trainer.method, trainer.mv_data, trainer.run_dir
    cam = mv["test"].cameras[0]
    t = time.perf_counter()
    path = trainer.save_checkpoint()
    sync(device)
    save_s = time.perf_counter() - t
    fresh = make_nerf(method.hp, device, seed=1)
    checkpoints.load_checkpoint(trainer.ckpt_dir, fresh)
    reloaded = Trainer(fresh, mv, os.path.join(run_dir, "reloaded"))
    ref = trainer.render_camera(cam, chunk)
    got = reloaded.render_camera(cam, chunk)
    result = dict(iter_nr=fresh.iter_nr, files=sorted(os.listdir(path)), bytes=dir_bytes(path),
                  save_s=save_s, outputs={k: list(v.shape) for k, v in got.items()},
                  render_equal=all(np.array_equal(got[k], ref[k]) for k in ref),
                  max_abs_diff=max(float(np.abs(got[k] - ref[k]).max()) for k in ref),
                  grid_equal=bool(torch.equal(fresh.grid.occupied, method.grid.occupied)))
    emit("nerf_checkpoint", **result)
    if not (result["render_equal"] and result["grid_equal"]) or fresh.iter_nr != method.iter_nr:
        raise AssertionError(f"nerf checkpoint round trip differs: {result}")
    del fresh, reloaded

    t = time.perf_counter()
    means = trainer.eval_split("test", chunk_size=chunk)
    emit("nerf_eval", split="test", cameras=len(mv["test"].cameras),
         seconds=time.perf_counter() - t, bar_psnr=NERF_PSNR_BAR, **means)
    if not means["psnr"] > NERF_PSNR_BAR:
        raise AssertionError(f"nerf: test psnr {means['psnr']} <= {NERF_PSNR_BAR}")
    if profile:
        emit("nerf_train_profile", steps=PROFILED_STEPS, rays=trainer._rays_bucket,
             **profiled(trainer.train_iteration, PROFILED_STEPS, top=8))
    return means


def phase_nerf(device, mv, scale=NERF_SCALE, profile=True):
    """The main path nerf_stage (phases 21-22), with the counts reset.
    Returns (its launches, the rays of its last step)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run_tmp = tempfile.TemporaryDirectory(prefix="vs_nerf_run_")
    t = time.perf_counter()
    reset_counts()  # the main path nerf_stage: train, checkpoint, evaluate, profile
    trainer = phase_nerf_train(device, mv, run_tmp.name, scale)
    phase_nerf_stage(device, trainer, CHUNK_SURF, profile)
    counts = read_counts()
    emit("nerf_stage_launches", seconds=time.perf_counter() - t, budget_s=NERF_BUDGET_S,
         **counts)
    rays = trainer._rays_bucket
    del trainer
    run_tmp.cleanup()
    torch.cuda.empty_cache()
    # K6, K7, K8a, K8b and K8d as kernels; not K1 (K6's backward adds the
    # table's gradient) nor K8c (NeuS'); no plain version
    ran = ("permuto_fwd", "permuto_bwd", "occupancy_sampler", "combine_samples",
           "neus_transmittance_fwd", "neus_transmittance_bwd", "nerf_importance")
    plain = [k for k, v in counts.items() if k.endswith("_reference") and v]
    if (min(counts[k] for k in ran) <= 0 or counts["scatter_add"] or counts["neus_importance"]
            or plain):
        raise AssertionError(f"the nerf path's launches are off: {counts}")
    return counts, rays


def _k8d_cost(R, S, n):
    """(bytes, operations) of one K8d call: z, dt, the mask and the density
    read once (13 B a sample), the jitter (4 B a target), the depths and
    mask written (5 B a target); ~20 operations a sample (the alpha's
    product, exponential, difference and clamps, the scan's factor and
    product, the weight, the sums and the normalised CDF entry) and
    2 log2(S) + 12 a new depth."""
    return R * S * 13 + R * n * 9, R * S * 20 + R * n * (2 * int(np.log2(S)) + 12)


def phase_nerf_importance(device, resources, cases):
    """K8d against its plain version (phase 23) at each case {name: R}:
    the nerf step's shape at the rays its path's last steps took and a
    2,048-ray render chunk's, 64 samples and 32 new depths
    (kernel_bench.k8d_case), with jitter: the masks equal, the depths by
    kernel_bench.k8_check's tolerance. Returns {name: row}."""
    from volsurfs_tpu_torch import kernel_bench as kb
    from volsurfs_tpu_torch.ops import volume_rendering as VR

    registers = resources.get("nerf_importance_kernel", {}).get("registers")
    rows = {}
    for name, R in cases.items():
        args = kb.k8d_case(device, R)
        got, ref = VR.nerf_importance(*args), VR.nerf_importance_reference(*args)
        check = kb.k8_check("importance", (got.z, got.mask), (ref.z, ref.mask))
        bound_ms, bound_by = _bound(*_k8d_cost(R, kb.K8D_UNIFORM, kb.K8D_IMP))
        fn = lambda: VR.nerf_importance(*args)  # noqa: E731
        row = dict(kernel="nerf_importance", case=name, rays=R, samples=kb.K8D_UNIFORM,
                   targets=kb.K8D_IMP, **check, ms=kb.time_ms(fn), device_ms=kb.device_ms(fn),
                   plain_ms=kb.time_ms(lambda: VR.nerf_importance_reference(*args), reps=5,
                                       warmup=1),
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=None, registers=registers)
        emit("k8d_nerf_importance", **row)
        if not check["ok"]:
            raise AssertionError(f"K8d ({name}) disagrees with its plain version: {row}")
        rows[name] = row
    return rows


def phase_marching(offsets):
    """The device marching against the CPU marching (phase 19): the main
    surface of the trained offsets_surfs model on a MARCHING_CHECK_RES^3
    grid, the same values marched on the card and on the host: faces
    equal, vertices within 1e-6."""
    from volsurfs_tpu_torch.baking.marching import (
        evaluate_grid,
        grid_origin_spacing,
        marching_tetrahedra,
    )

    res, bounds = MARCHING_CHECK_RES, float(offsets.radius)
    values = evaluate_grid(lambda p: offsets._sdfs(p, offsets.iter_nr)[0][..., 0], res, bounds,
                           device=offsets.device)[..., offsets.main_surf_idx].contiguous()
    origin, spacing = grid_origin_spacing(res, bounds)
    sync(offsets.device)
    t = time.perf_counter()
    dv, df = marching_tetrahedra(values, origin, spacing)
    device_s = time.perf_counter() - t
    t = time.perf_counter()
    hv, hf = marching_tetrahedra(values.cpu(), origin, spacing)
    host_s = time.perf_counter() - t
    result = dict(res=res, verts=len(dv), faces=len(df), faces_equal=bool(np.array_equal(df, hf)),
                  max_abs_vert_err=float(np.abs(dv - hv).max()) if len(dv) == len(hv) and len(dv)
                  else None, device_s=device_s, host_s=host_s, tolerance=1e-6)
    emit("pipeline_marching_check", **result)
    if not (result["faces_equal"] and len(df) > 0 and result["max_abs_vert_err"] <= 1e-6):
        raise AssertionError(f"the device marching differs from the host's: {result}")
    return result


def phase_pipeline(device, offsets, mv, chunk):
    """The main path pipeline_stage (phase 20): the pipeline's stages 3-5
    from the trained offsets_surfs model of phase 16: its shells extracted
    on the card at EXTRACTION_RES^3, simplified at SIMPLIFY_RATIO and
    atlased; the volsurfs stage at base_5.cfg's width on them through
    Trainer.train (TRAIN_STEPS steps, the train path's cut); eval_split;
    the textures and scene.json baked into the run directory; the run
    directory rendered through BakedMeshRenderer on the test cameras.
    Returns its launches."""
    from volsurfs_tpu_torch.baking import baker
    from volsurfs_tpu_torch.renderers.mesh_renderer import BakedMeshRenderer
    from volsurfs_tpu_torch.utils.evaluation import psnr

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run_tmp = tempfile.TemporaryDirectory(prefix="vs_pipeline_run_")
    run_dir = run_tmp.name
    seconds = {}
    t0 = time.perf_counter()
    reset_counts()  # the main path pipeline_stage: extract, simplify, train, evaluate, bake
    t = time.perf_counter()
    raw = baker.extract_meshes_from_offsets_surfs(offsets, resolution=EXTRACTION_RES)
    seconds["extract"] = time.perf_counter() - t
    t = time.perf_counter()
    shells = baker.simplify_and_atlas(raw, SIMPLIFY_RATIO)
    seconds["simplify_and_atlas"] = time.perf_counter() - t
    baker.save_meshes(run_dir, shells)
    meshes = dict(raw=[[len(v), len(f)] for v, f in raw],
                  simplified=[[len(v), len(f)] for v, f, _ in shells])
    emit("pipeline_meshes", cuts={"extraction_res": [256, EXTRACTION_RES]},
         extraction_res=EXTRACTION_RES, simplify_ratio=SIMPLIFY_RATIO,
         seconds=dict(seconds), **meshes)
    if len(shells) != offsets.nr_surfs or min(min(vf) for vf in meshes["simplified"]) <= 10:
        raise AssertionError(f"pipeline: a shell is empty or degenerate: {meshes}")

    hp = smoke_hyper_params()
    t = time.perf_counter()
    trainer = phase_train(device, shells, mv, hp, run_dir, prefix="pipeline_")
    seconds["volsurfs_train"] = time.perf_counter() - t
    t = time.perf_counter()
    means = trainer.eval_split("test", chunk_size=chunk)
    seconds["eval"] = time.perf_counter() - t
    t = time.perf_counter()
    meshes_info = baker.bake_textures(trainer.method, run_dir)
    baker.export_scene_json(run_dir, meshes_info, mv, bg_color="white", sh_degree=hp.sh_degree)
    seconds["bake"] = time.perf_counter() - t
    t = time.perf_counter()
    renderer = BakedMeshRenderer(run_dir, device=device)
    test = mv["test"]
    baked = [renderer.render(cam) for cam in test.cameras]
    seconds["baked_render"] = time.perf_counter() - t
    baked_psnr = [psnr(test.rgbs[i], img) for i, img in enumerate(baked)]
    counts = read_counts()
    seconds["path"] = time.perf_counter() - t0
    result = dict(shells=len(shells), volsurfs_psnr=means["psnr"], volsurfs_eval=means,
                  volsurfs_bar=PIPELINE_VOLSURFS_PSNR_BAR, baked_psnr=baked_psnr,
                  baked_mean_psnr=float(np.mean(baked_psnr)), baked_bar=PIPELINE_BAKED_PSNR_BAR,
                  finite=bool(all(np.isfinite(img).all() for img in baked)), seconds=seconds,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("pipeline_stage", **result)
    emit("pipeline_stage_launches", **counts)
    del trainer, renderer
    run_tmp.cleanup()
    torch.cuda.empty_cache()
    if not (result["finite"] and means["psnr"] > PIPELINE_VOLSURFS_PSNR_BAR
            and result["baked_mean_psnr"] > PIPELINE_BAKED_PSNR_BAR):
        raise AssertionError(f"pipeline: below its bars: {result}")
    return counts


# the surf stage with the trained background (phases 24-29): surf_hyper_params'
# configuration and cut with bg_color "trained"; the sphere-traced render of
# test camera 0 takes the surf bar too; the scene's background is white, and
# the background field's mean |rgb_bg - 1| over test camera 0's background
# pixels must stay below BG_WHITE_BAR; the volsurfs stage on the committed
# shells with the carried background takes the pipeline's volsurfs bar
SURF_BG_TRACED_PSNR_BAR = SURF_PSNR_BAR
BG_WHITE_BAR = 0.1
VOLSURFS_BG_PSNR_BAR = PIPELINE_VOLSURFS_PSNR_BAR
TRACE_STEPS = 24  # Surf.render_rays_sphere_traced's max_st_steps
# the witness trace of phase 26: the same frame with the cap at 100 steps,
# which tells a trace cut short by its cap from a fault in the trace or its
# shading (no bar: it is read beside the capped trace's numbers)
WITNESS_TRACE_STEPS = 100


def _camera_rays(device, cam):
    from volsurfs_tpu_torch.datasets.cameras import get_camera_rays

    return tuple(torch.from_numpy(x).to(device) for x in get_camera_rays(cam))


def phase_surf_bg_stage(device, mv, run_dir, chunk):
    """The surf stage with the trained background (phases 24-25): training
    through Trainer.train at the surf path's cut, the checkpoint round trip
    (bg included) and eval_split, and the background field's mean
    |rgb_bg - 1| over test camera 0's background pixels. Returns the
    trainer."""
    from volsurfs_tpu_torch.methods.base import render_frame_chunked

    trainer = phase_surf_train(device, mv, run_dir, bg_color="trained", prefix="surf_bg")
    method = trainer.method
    means = phase_surf_stage(device, trainer, chunk, prefix="surf_bg", profile=False)
    test = mv["test"]
    rays_o, rays_d = _camera_rays(device, test.cameras[0])

    def render(o, d):
        with torch.no_grad():
            res = method.render_rays(o, d)
        return {k: res[k] for k in ("rgb_bg", "weights_sum")}

    out = render_frame_chunked(render, rays_o, rays_d, chunk)
    background = torch.from_numpy(test.masks[0].reshape(-1) < 0.5).to(device)
    err = float(torch.abs(out["rgb_bg"] - 1.0)[background].mean())
    result = dict(psnr=means["psnr"], bg_pixels=int(background.sum()),
                  mean_abs_rgb_bg_minus_1=err, bar=BG_WHITE_BAR,
                  params_bg=sum(p.numel() for p in method.models["bg"].parameters()),
                  nr_samples_bg=method.hp.nr_samples_bg)
    emit("surf_bg_background", **result)
    if not err < BG_WHITE_BAR:
        raise AssertionError(f"surf_bg: the background did not learn the white scene: {result}")
    return trainer


def _trace_gap(method, rays_o, rays_d, test, rgb_traced, traced_hit, rgb_volume, vol_hit,
               nr_samples=512):
    """Where the sphere-traced frame loses to the volume render: each
    render's squared error split over the pixels both hit, only the volume
    render hits, only the trace hits and neither hits; each render's hits
    against the ground truth's mask; and along the rays that only the
    volume render hits, the SDF at nr_samples even depths through the
    bounding primitive: the share whose SDF turns negative (a surface the
    trace missed) and the median of their least SDF."""
    from volsurfs_tpu_torch.ops import raycast as RC

    gt = np.asarray(test.rgbs[0], dtype=np.float64).reshape(-1, 3)
    mask = np.asarray(test.masks[0]).reshape(-1) > 0.5
    groups = {"both_hit": traced_hit & vol_hit, "volume_only": vol_hit & ~traced_hit,
              "trace_only": traced_hit & ~vol_hit, "neither": ~traced_hit & ~vol_hit}
    split = {}
    for name, img in (("traced", rgb_traced), ("volume", rgb_volume)):
        err = ((np.asarray(img, dtype=np.float64).reshape(-1, 3) - gt) ** 2).sum(-1)
        split[name] = {g: float(err[m].sum() / err.sum()) for g, m in groups.items()}
        split[name]["mse"] = float(err.mean() / 3)
    only = torch.from_numpy(groups["volume_only"]).to(rays_o.device)
    o, d = rays_o[only], rays_d[only]
    least = torch.empty(0, device=rays_o.device)
    if o.shape[0]:
        rc = RC.intersect_bounding_primitive(method.bounding_primitive, o, d)
        u = torch.linspace(0.0, 1.0, nr_samples, device=o.device)[None, :]
        t = rc["t_near"] + (rc["t_far"] - rc["t_near"]) * u
        with torch.no_grad():
            sdf = torch.cat([method._sdf(p, method.iter_nr)[0][:, 0] for p in torch.split(
                (o[:, None] + t[..., None] * d[:, None]).reshape(-1, 3), 65536)])
        least = sdf.reshape(-1, nr_samples).amin(dim=1)
    return dict(sq_error_share=split, pixels={g: int(m.sum()) for g, m in groups.items()},
                mask_disagreement_traced=float((traced_hit != mask).mean()),
                mask_disagreement_volume=float((vol_hit != mask).mean()),
                volume_only_rays=int(o.shape[0]),
                volume_only_sdf_turns_negative=float((least < 0).float().mean())
                if o.shape[0] else None,
                volume_only_median_least_sdf=float(least.median()) if o.shape[0] else None)


def phase_surf_bg_traced(device, trainer, chunk):
    """The sphere-traced render of test camera 0 through
    make_render_fn(sphere_traced=True) (phase 26): psnr against the ground
    truth, the share of pixels whose hit differs from the volume render's
    weights_sum > 0.5, the steps taken and the seconds a frame. Returns its
    row."""
    from volsurfs_tpu_torch.utils.evaluation import psnr

    method, test = trainer.method, trainer.mv_data["test"]
    cam = test.cameras[0]
    rays_o, rays_d = _camera_rays(device, cam)
    render = method.make_render_fn(sphere_traced=True)
    render(rays_o, rays_d)  # warm-up
    times = []
    for _ in range(3):
        sync(device)
        t = time.perf_counter()
        out = render(rays_o, rays_d)
        rgb = out["rgb"].cpu().numpy()
        times.append(time.perf_counter() - t)
    H, W = cam.height, cam.width
    traced_psnr = psnr(test.rgbs[0], rgb.reshape(H, W, 3))
    volume = trainer.render_camera(cam, chunk)
    vol_hit = volume["weights_sum"].reshape(-1) > 0.5
    traced_hit = out["weights_sum"][:, 0].cpu().numpy() > 0.5
    row = dict(rays=H * W, psnr=traced_psnr, bar_psnr=SURF_BG_TRACED_PSNR_BAR,
               volume_psnr=psnr(test.rgbs[0], volume["rgb"]),
               hit_share=float(traced_hit.mean()), volume_hit_share=float(vol_hit.mean()),
               hit_disagreement=float((traced_hit != vol_hit).mean()),
               steps=method.last_trace_steps, max_steps=TRACE_STEPS,
               seconds_a_frame=float(np.median(times)), seconds=times,
               finite=bool(np.isfinite(rgb).all()))
    emit("surf_bg_traced", **row)
    sync(device)
    t = time.perf_counter()
    with torch.no_grad():
        wit = method.render_rays_sphere_traced(rays_o, rays_d, method.iter_nr,
                                               max_st_steps=WITNESS_TRACE_STEPS)
    wit_rgb = wit["rgb"].cpu().numpy()
    wit_hit = wit["weights_sum"][:, 0].cpu().numpy() > 0.5
    emit("surf_bg_traced_witness", max_steps=WITNESS_TRACE_STEPS,
         steps=method.last_trace_steps, seconds=time.perf_counter() - t,
         psnr=psnr(test.rgbs[0], wit_rgb.reshape(H, W, 3)),
         hit_share=float(wit_hit.mean()),
         hit_disagreement_with_volume=float((wit_hit != vol_hit).mean()),
         hit_disagreement_with_capped=float((wit_hit != traced_hit).mean()),
         finite=bool(np.isfinite(wit_rgb).all()),
         **_trace_gap(method, rays_o, rays_d, test, rgb, traced_hit, volume["rgb"], vol_hit))
    if not (row["finite"] and traced_psnr > SURF_BG_TRACED_PSNR_BAR):
        raise AssertionError(f"surf_bg: the sphere-traced render is below its bar: {row}")
    return row


def phase_surf_bg_profile(trainer):
    """3 profiled data steps with the trained background (phase 28), beside
    the surf_stage path's: busy ms, launches and idle share, and what the
    background adds."""
    prof = PROFILES["surf_bg"] = profiled(trainer.train_iteration, PROFILED_STEPS)
    base = PROFILES.get("surf", {})
    added = {k: prof[k] - base[k] for k in ("wall_ms", "device_busy_ms", "kernels") if k in base}
    emit("surf_bg_train_profile", steps=PROFILED_STEPS, rays=trainer._rays_bucket,
         surf_stage={k: base.get(k) for k in ("wall_ms", "device_busy_ms", "kernels",
                                             "idle_share")},
         added_by_background=added, **prof)


# the compacted trace against the lockstep one at the trained field: at
# most this share of rays may hit in one and not the other, and where both
# hit t within K9_TRACE_DT (the MLP, cuBLAS, may round a row otherwise at
# another batch size)
K9_TRACE_HIT_SHARE = 5e-4
K9_TRACE_DT = 1e-5


def phase_k9_k10(device, resources, trainer):
    """K10 and K9 against their plain versions (phase 27), after the path's
    launches were read: K10 at each of kernel_bench.K10_CASES' shapes and
    K10_CHECK_CASES' (a row of 48 samples), bit for bit; K9's compacted
    march of the test camera's 256^2 rays against the compacted plain
    march, 24 steps, each step given the same SDF by ray, at the analytic
    sphere (without and with a 256^3 grid) and at the trained surf field
    with its grid, bit for bit, and a step's time at the march's state
    after 6 steps; K6's forward at the trained background's contracted
    points (both signs of every coordinate), bit for bit; and the trace at
    the trained field, compacted against JAX's lockstep loop with the plain
    step (t and flags, within K9_TRACE_HIT_SHARE and K9_TRACE_DT), with
    both traces' device busy ms and launches (the lockstep one as every ray
    stepped by K9) and the traced frame's psnr by each. Times, bounds and
    registers. Returns (K9's row at the trained field, K10's at surf's
    step)."""
    from volsurfs_tpu_torch import kernel_bench as kb
    from volsurfs_tpu_torch.ops import permuto as P
    from volsurfs_tpu_torch.ops import samplers as SP
    from volsurfs_tpu_torch.ops import sphere_tracing as ST
    from volsurfs_tpu_torch.utils.evaluation import psnr

    method = trainer.method
    k10_rows = {}
    registers = resources.get("bg_samples_kernel", {}).get("registers")
    for case, (R, N, jitter) in {**kb.K10_CASES, **kb.K10_CHECK_CASES}.items():
        args = kb.k10_case(device, R, N, jitter)
        check = kb.k10_check(SP.contracted_bg_samples(*args), SP.bg_samples_reference(*args))
        bound_ms, bound_by = _bound(*kb.k10_cost(R, N, jitter), kb.ISSUE_PER_S)
        fn = lambda: SP.contracted_bg_samples(*args)  # noqa: E731
        row = dict(kernel="bg_samples", case=case, rays=R, samples=N, jitter=jitter, **check,
                   ms=kb.time_ms(fn), device_ms=kb.device_ms(fn),
                   plain_ms=kb.time_ms(lambda: SP.bg_samples_reference(*args), reps=5,
                                       warmup=1),
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=None, registers=registers,
                   spills=resources.get("bg_samples_kernel", {}).get("spill_stores"))
        emit("k10_bg_samples", **row)
        if not check["ok"]:
            raise AssertionError(f"K10 ({case}) disagrees with its plain version: {row}")
        k10_rows[case] = row

    registers = resources.get("sphere_trace_step_kernel", {}).get("registers")
    rays_o, rays_d = _camera_rays(device, trainer.mv_data["test"].cameras[0])

    def field_sdf(p):
        with torch.no_grad():
            return method._sdf(p, method.iter_nr)[0]

    cases = {"analytic": kb.k9_case(device, grid=False, pre_steps=0),
             "analytic_grid256": kb.k9_case(device, grid=True, pre_steps=0)}
    space = ST.trace_space(method.bounding_primitive, 1e-3, 8e-3, method.grid)
    cases["trained_field_grid256"] = (rays_o, rays_d, field_sdf, space,
                                      ST.trace_start(rays_o, rays_d, space))
    k9_row = None
    for case, (o, d, sdf, sp, state) in cases.items():
        check = kb.k9_march_check(o, d, sdf, sp, state, steps=TRACE_STEPS)
        # a step at the march's state after 6 steps (most rays still going)
        st = state
        for _ in range(6):
            st = ST.sphere_trace_step_reference(st, sdf(o + st[0][:, None] * d)[:, 0], o, d, sp)
        sdf1 = sdf(o + st[0][:, None] * d)[:, 0].contiguous()
        grid = sp.grid is not None
        fn, listed, next_rays = kb.k9_step_fn(st, sdf1, o, d, sp)
        bound_ms, bound_by = _bound(*kb.k9_cost(listed, grid, next_rays), kb.ISSUE_PER_S)
        active = ST.active_rays(st, o, d)[0]
        plain_work = tuple(x.clone() for x in st)
        plain_sdf = sdf1.index_select(0, active)
        row = dict(kernel="sphere_trace_step", case=case, rays=o.shape[0], grid=grid,
                   active=listed, next_active=next_rays, **check, ms=kb.time_ms(fn),
                   device_ms=kb.device_ms(fn),
                   plain_ms=kb.time_ms(lambda: ST.compact_step_reference(
                       plain_work, active, plain_sdf, o, d, sp), reps=5, warmup=1),
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=None, registers=registers,
                   spills=resources.get("sphere_trace_step_kernel", {}).get("spill_stores"))
        emit("k9_sphere_trace_step", **row)
        if not check["ok"]:
            raise AssertionError(f"K9 ({case}) disagrees with its plain version: {row}")
        if case == "trained_field_grid256":
            k9_row = row

    # K6's forward at the background's contracted points of surf's step
    args = kb.k10_case(device, *kb.K10_CASES["surf_step"][:2], jitter=True)
    cpos = SP.contracted_bg_samples(*args)[0].reshape(-1, 3).contiguous()
    enc = method.models["bg"].encoder
    fwd = (cpos, enc.table.detach(), enc.W, enc.level_sizes, enc.level_offsets, None)
    got, ref = P.permuto_forward(*fwd), P.permuto_forward_reference(*fwd, save=False)
    differ = int((got[0] != ref[0]).sum())
    emit("k6_bg_points", points=cpos.shape[0], negative_share=float((cpos < 0).float().mean()),
         min=float(cpos.min()), max=float(cpos.max()), entries_differ=differ,
         ms=kb.time_ms(lambda: P.permuto_forward(*fwd)))
    if differ:
        raise AssertionError(f"K6 at the background's points differs from its plain version "
                             f"in {differ} entries")

    # the trace at the trained field: compacted (the main path's), JAX's
    # lockstep loop with the plain step, and that loop with every ray
    # stepped by K9 (the shape of the trace before compaction)
    def field(p):
        return field_sdf(p)[:, 0]

    def compacted():
        return ST.march(field, rays_o, rays_d, space, TRACE_STEPS)

    every = torch.arange(rays_o.shape[0], dtype=torch.int32, device=device)

    def lockstep_kernel():
        state, steps = ST.trace_start(rays_o, rays_d, space), 0
        counts = torch.zeros(TRACE_STEPS, dtype=torch.int32, device=device)
        while steps < TRACE_STEPS and bool(torch.any(~state[7])):
            state = ST.sphere_trace_step(state, every, field(rays_o + state[0][:, None] * rays_d),
                                         rays_o, rays_d, space, counts[steps:steps + 1])[0]
            steps += 1
        return state, steps

    (c, n_c), (lk, n_lk) = compacted(), lockstep_kernel()
    ls, n_ls = ST.march_lockstep_reference(field, rays_o, rays_d, space, TRACE_STEPS)
    hit_c, hit_ls = c[6] | c[5], ls[6] | ls[5]
    both = hit_c & hit_ls
    flags = (0, 5, 6, 7)
    result = dict(
        steps=n_c, steps_lockstep=n_ls,
        same_result=n_c == n_ls and all(torch.equal(c[k], ls[k]) for k in flags),
        hit_differ_share=float((hit_c != hit_ls).float().mean()),
        max_abs_dt_both_hit=float((c[0] - ls[0]).abs()[both].max()) if bool(both.any()) else 0.0,
        lockstep_kernel_same_as_plain=n_lk == n_ls and all(torch.equal(lk[k], ls[k])
                                                           for k in flags),
        bar_hit_share=K9_TRACE_HIT_SHARE, bar_dt=K9_TRACE_DT)
    result["compacted_ms"] = kb.time_ms(compacted, reps=5)
    result["lockstep_kernel_ms"] = kb.time_ms(lockstep_kernel, reps=5)
    for name, fn in (("compacted", compacted), ("lockstep_kernel", lockstep_kernel)):
        prof = profiled(fn, 3)
        result[name] = {k: prof[k] for k in ("wall_ms", "device_busy_ms", "kernels",
                                              "idle_share", "watched_ms_launches")}
    result["busy_ratio_lockstep_to_compacted"] = (result["lockstep_kernel"]["device_busy_ms"]
                                                  / result["compacted"]["device_busy_ms"])
    # the traced frame's psnr, compacted and by the lockstep loop
    test = trainer.mv_data["test"]
    H, W = test.cameras[0].height, test.cameras[0].width

    def frame_psnr():
        out = method.render_rays_sphere_traced(rays_o, rays_d, method.iter_nr)
        return psnr(test.rgbs[0], out["rgb"].cpu().numpy().reshape(H, W, 3))

    result["psnr_compacted"] = frame_psnr()
    compacted_march = ST.march  # sphere_trace's march, for this one frame
    ST.march = ST.march_lockstep_reference
    try:
        result["psnr_lockstep"] = frame_psnr()
    finally:
        ST.march = compacted_march
    result["psnr_delta"] = result["psnr_compacted"] - result["psnr_lockstep"]
    emit("sphere_trace_loop", **result)
    if not (result["hit_differ_share"] <= K9_TRACE_HIT_SHARE
            and result["max_abs_dt_both_hit"] <= K9_TRACE_DT
            and result["lockstep_kernel_same_as_plain"]):
        raise AssertionError(f"the compacted trace is off the lockstep trace: {result}")
    return k9_row, k10_rows["surf_step"]


def phase_surf_bg(device, mv, resources, chunk):
    """The main path surf_bg_stage (phases 24-26 and 28) with the counts
    reset before it and read after, then phase 27 (K9 and K10 against their
    plain versions). Returns (its launches, K9's row, K10's row, the
    trained method)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run_tmp = tempfile.TemporaryDirectory(prefix="vs_surf_bg_run_")
    t = time.perf_counter()
    reset_counts()  # the main path surf_bg_stage: train, checkpoint, evaluate, trace, profile
    trainer = phase_surf_bg_stage(device, mv, run_tmp.name, chunk)
    phase_surf_bg_traced(device, trainer, chunk)
    phase_surf_bg_profile(trainer)
    counts = read_counts()
    emit("surf_bg_stage_launches", seconds=time.perf_counter() - t,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **counts)
    # K6, K7, K8a, K8b, K8c, K9 and K10 as kernels; not K1; no plain version
    ran = ("permuto_fwd", "permuto_bwd", "occupancy_sampler", "combine_samples",
           "neus_transmittance_fwd", "neus_transmittance_bwd", "neus_importance",
           "sphere_trace_step", "bg_samples")
    plain = [k for k, v in counts.items() if k.endswith("_reference") and v]
    if min(counts[k] for k in ran) <= 0 or counts["scatter_add"] or plain:
        raise AssertionError(f"the surf_bg path's launches are off: {counts}")
    k9, k10 = phase_k9_k10(device, resources, trainer)
    method = trainer.method
    del trainer
    run_tmp.cleanup()
    return counts, k9, k10, method


def phase_volsurfs_bg(device, mv, bg_source, chunk):
    """The main path volsurfs_bg_stage (phase 29), with the counts reset:
    the volsurfs stage at base_5.cfg's width on the committed sphere-scene
    shells with the trained background, carried from bg_source (phase 24's
    model) by pipeline._carry_bg, TRAIN_STEPS steps through Trainer.train,
    then eval_split (psnr > the pipeline's volsurfs bar). Returns its
    launches."""
    from volsurfs_tpu_torch.datasets import sphere_scene

    torch.cuda.empty_cache()
    run_tmp = tempfile.TemporaryDirectory(prefix="vs_volsurfs_bg_run_")
    t = time.perf_counter()
    reset_counts()  # the main path volsurfs_bg_stage: train, evaluate
    hp = smoke_hyper_params()
    trainer = phase_train(device, sphere_scene.load_shells(), mv, hp, run_tmp.name,
                          prefix="volsurfs_bg_", bg_source=bg_source)
    means = trainer.eval_split("test", chunk_size=chunk)
    counts = read_counts()
    emit("volsurfs_bg_eval", split="test", bar_psnr=VOLSURFS_BG_PSNR_BAR,
         nr_samples_bg=hp.nr_samples_bg, seconds=time.perf_counter() - t, **means)
    emit("volsurfs_bg_stage_launches", **counts)
    del trainer
    run_tmp.cleanup()
    torch.cuda.empty_cache()
    # K1, K2, K6 (the background's field), K8b (its scan) and K10 as
    # kernels; no plain version
    ran = ("scatter_add", "bvh_trace", "permuto_fwd", "permuto_bwd", "neus_transmittance_fwd",
           "neus_transmittance_bwd", "bg_samples")
    plain = [k for k, v in counts.items() if k.endswith("_reference") and v]
    if min(counts[k] for k in ran) <= 0 or plain:
        raise AssertionError(f"the volsurfs_bg path's launches are off: {counts}")
    if not means["psnr"] > VOLSURFS_BG_PSNR_BAR:
        raise AssertionError(f"volsurfs_bg: test psnr {means['psnr']} <= {VOLSURFS_BG_PSNR_BAR}")
    return counts


def main():
    if sys.argv[1:2] == ["--orbit-profile"]:
        return orbit_profile(sys.argv[2])
    name, smi = phase_device()
    device = torch.device("cuda")
    resources, sass = phase_build()

    from volsurfs_tpu_torch import kernel_bench as kb
    from volsurfs_tpu_torch.datasets import sphere_scene
    from volsurfs_tpu_torch.datasets.mvdataset import MVDataset
    from volsurfs_tpu_torch.datasets.tensor_reel import make_tensor_reel
    k1 = phase_scatter_add(device)
    shells = sphere_scene.load_shells()
    mv = MVDataset("synthetic", "sphere", "", config=STAGE_DATA)
    reel = make_tensor_reel(mv["train"].cameras, mv["train"].rgbs, mv["train"].masks,
                            device=device)
    k2_shapes = phase_trace(device, shells, reel)
    k2 = k2_shapes[f"frame_5x{sphere_scene.FRAME ** 2}"]

    rays_o, rays_d, gt = sphere_scene.test_camera(device)
    torch.cuda.reset_peak_memory_stats()
    hp = smoke_hyper_params()
    run_tmp = tempfile.TemporaryDirectory(prefix="vs_stage_run_")
    reset_counts()  # the main paths train_render and volsurfs_stage: train, then render
    trainer = phase_train(device, shells, mv, hp, run_tmp.name)
    trainer.method.stacked_bvh.check_step_cap()
    phase_render(device, trainer.method, rays_o, rays_d, gt, kb.CHUNK)
    trainer.method.stacked_bvh.check_step_cap()
    counts = read_counts()
    emit("train_render_launches", **counts)
    # the volsurfs stage goes on from the trained method, counts not reset
    phase_stage(device, trainer, hp, shells, kb.CHUNK)
    stage = read_counts()
    emit("volsurfs_stage_launches", **stage)
    del trainer
    run_tmp.cleanup()
    torch.cuda.empty_cache()

    k4, baked = phase_baked(device, smi, sass)
    k6, k7, surf, sdf_state, surf_rays = phase_surf(device, reel, mv, resources)
    offsets, offsets_rays, offsets_method = phase_offsets(device, mv, sdf_state)
    k8 = phase_volrender(device, resources, {"surf_step": (1, surf_rays),
                                             "offsets_step": (5, offsets_rays),
                                             "surf_eval_chunk": (1, kb.K8_EVAL_RAYS)})
    phase_marching(offsets_method)
    pipeline = phase_pipeline(device, offsets_method, mv, kb.CHUNK)
    del offsets_method
    nerf, nerf_rays = phase_nerf(device, mv)
    k8d = phase_nerf_importance(device, resources, {"nerf_step": nerf_rays,
                                                    "render_chunk": kb.K8_EVAL_RAYS})
    surf_bg, k9, k10, surf_bg_method = phase_surf_bg(device, mv, resources, CHUNK_SURF)
    volsurfs_bg = phase_volsurfs_bg(device, mv, surf_bg_method, kb.CHUNK)
    del surf_bg_method

    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # launches: over the volsurfs stage (which begins with train_render), the
    # baked render path and the surf stage. K1 is off the surf path: K6's
    # backward accumulates the table's gradient itself
    for path, counts_ in (("surf", surf), ("offsets_surfs", offsets)):
        if counts_["scatter_add"] != 0:
            raise AssertionError(f"the {path} stage launched K1 {counts_['scatter_add']} times")
    # the pipeline path runs K6 (the extraction's field), K1 (the volsurfs
    # stage's texture backward), K2 and K4 (training, evaluation, the baked
    # render), and none of their plain versions
    for count in ("permuto_fwd", "scatter_add", "bvh_trace", "shade"):
        if pipeline[count] <= 0 or pipeline[count + "_reference"] != 0:
            raise AssertionError(f"the pipeline path did not run {count} as a kernel: {pipeline}")
    kernels = [
        dict(name="scatter_add_rows", route="cuda",
             source="volsurfs_tpu_torch/csrc/scatter_add.cu",
             replaces="volsurfs_tpu/ops/pallas/scatter_add.py:107",
             launches=stage["scatter_add"] + pipeline["scatter_add"]
             + volsurfs_bg["scatter_add"],
             launches_by_path={"train_render": counts["scatter_add"],
                               "volsurfs_stage": stage["scatter_add"],
                               "pipeline_stage": pipeline["scatter_add"],
                               "volsurfs_bg_stage": volsurfs_bg["scatter_add"]},
             plain_launches=stage["scatter_add_reference"] + surf["scatter_add_reference"]
             + pipeline["scatter_add_reference"] + volsurfs_bg["scatter_add_reference"],
             shape="hashgrid_backward",
             registers=resources.get("scatter_add_rows_f2_kernel", {}).get("registers"),
             **{k: k1[k] for k in keys}),
        dict(name="bvh_trace", route="cuda",
             source="volsurfs_tpu_torch/csrc/bvh_trace.cu",
             replaces="volsurfs_tpu/ops/bvh.py:490",
             launches=stage["bvh_trace"] + baked["bvh_trace"] + pipeline["bvh_trace"]
             + volsurfs_bg["bvh_trace"],
             launches_by_path={"train_render": counts["bvh_trace"],
                               "volsurfs_stage": stage["bvh_trace"],
                               "baked_render": baked["bvh_trace"],
                               "pipeline_stage": pipeline["bvh_trace"],
                               "volsurfs_bg_stage": volsurfs_bg["bvh_trace"]},
             plain_launches=stage["bvh_trace_reference"] + baked["bvh_trace_reference"]
             + pipeline["bvh_trace_reference"] + volsurfs_bg["bvh_trace_reference"],
             shape=k2["shape"],
             registers=resources.get("bvh_trace_kernel", {}).get("registers"),
             **{k: k2[k] for k in keys}),
        dict(name="shade_composite", route="cuda",
             source="volsurfs_tpu_torch/csrc/shade.cu",
             replaces="volsurfs_tpu/renderers/mesh_renderer.py:271",
             launches=stage["shade"] + baked["shade"] + pipeline["shade"],
             launches_by_path={"volsurfs_stage": stage["shade"], "baked_render": baked["shade"],
                               "pipeline_stage": pipeline["shade"]},
             plain_launches=stage["shade_reference"] + baked["shade_reference"]
             + pipeline["shade_reference"],
             shape=k4["shape"],
             registers=resources.get("shade_composite_deg3_kernel", {}).get("registers"),
             sass=k4["sass"], entries_differ=k4["entries_differ"],
             **{k: k4[k] for k in keys}),
    ]
    for kernel, side, fn in (("permuto_forward", "fwd_", "permuto_forward_grads_kernel"),
                             ("permuto_backward", "bwd_", "permuto_backward_grads_points_kernel")):
        count = "permuto_" + side[:-1]
        # the pipeline path evaluates its field without grads: K6's forward only
        paths = {"surf_stage": surf, "offsets_stage": offsets, "nerf_stage": nerf,
                 "surf_bg_stage": surf_bg, "volsurfs_bg_stage": volsurfs_bg}
        if side == "fwd_":
            paths["pipeline_stage"] = pipeline
        kernels.append(dict(
            name=kernel, route="cuda", source="volsurfs_tpu_torch/csrc/permuto.cu",
            replaces="volsurfs_tpu/models/encodings.py:1039",
            launches=sum(c[count] for c in paths.values()),
            launches_by_path={p: c[count] for p, c in paths.items()},
            plain_launches=sum(c[count + "_reference"] for c in paths.values()),
            shape="data_step_49152_with_grads_and_points_grad", kernel=fn,
            registers=resources.get(fn, {}).get("registers"),
            entries_differ=k6["entries_differ"],
            # the forward and the points' gradient bit for bit; the table's
            # gradient to the atomics' summation order
            max_abs_err=0.0 if side == "fwd_" else k6["d_table_max_abs_err"],
            **{k: k6[side + k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
            library_ms=None))
    kernels.append(dict(
        name="occupancy_samples", route="cuda",
        source="volsurfs_tpu_torch/csrc/occupancy_sampler.cu",
        replaces="volsurfs_tpu/ops/samplers.py:105",
        launches=surf["occupancy_sampler"] + offsets["occupancy_sampler"]
        + nerf["occupancy_sampler"] + surf_bg["occupancy_sampler"],
        launches_by_path={"surf_stage": surf["occupancy_sampler"],
                          "offsets_stage": offsets["occupancy_sampler"],
                          "nerf_stage": nerf["occupancy_sampler"],
                          "surf_bg_stage": surf_bg["occupancy_sampler"]},
        plain_launches=surf["occupancy_sampler_reference"]
        + offsets["occupancy_sampler_reference"] + nerf["occupancy_sampler_reference"]
        + surf_bg["occupancy_sampler_reference"],
        shape=k7["shape"],
        registers={n: r.get("registers") for n, r in resources.items()
                   if n.startswith("occupancy_samples")},
        entries_differ=k7["entries_differ"], **{k: k7[k] for k in keys}))
    # K8 at the offsets_surfs step's shapes (the k8_volrender lines hold both paths')
    for kernel, count, plain, fn, line in (
            ("combine_samples", "combine_samples", "combine_samples_reference",
             "combine_samples_c3_kernel", "volsurfs_tpu/ops/samples.py:148"),
            ("neus_transmittance_forward", "neus_transmittance_fwd",
             "neus_transmittance_reference", "neus_transmittance_forward_kernel",
             "volsurfs_tpu/ops/volume_rendering.py:36"),
            ("neus_transmittance_backward", "neus_transmittance_bwd",
             "neus_transmittance_reference", "neus_transmittance_backward_kernel",
             "volsurfs_tpu/ops/volume_rendering.py:36"),
            ("neus_importance", "neus_importance", "neus_importance_reference",
             "neus_importance_kernel", "volsurfs_tpu/ops/volume_rendering.py:137")):
        row = k8["offsets_step"][kernel]
        # the nerf path runs K8a and K8b, not K8c (NeuS' importance round);
        # the volsurfs_bg path K8b alone (the background's scan)
        paths = {"surf_stage": surf, "offsets_stage": offsets, "surf_bg_stage": surf_bg}
        if kernel != "neus_importance":
            paths["nerf_stage"] = nerf
        if kernel.startswith("neus_transmittance"):
            paths["volsurfs_bg_stage"] = volsurfs_bg
        kernels.append(dict(
            name=kernel, route="cuda", source="volsurfs_tpu_torch/csrc/volrender.cu",
            replaces=line, launches=sum(c[count] for c in paths.values()),
            launches_by_path={p: c[count] for p, c in paths.items()},
            plain_launches=sum(c[plain] for c in paths.values()),
            shape=f"{row['surfaces']}_surfaces_{row['rays']}_rays_{row['case']}", kernel=fn,
            registers=resources.get(fn, {}).get("registers"),
            entries_differ=row["entries_differ"], **{k: row[k] for k in keys}))
    row = k8d["nerf_step"]
    kernels.append(dict(
        name="nerf_importance", route="cuda", source="volsurfs_tpu_torch/csrc/volrender.cu",
        replaces="volsurfs_tpu/methods/nerf.py:143", launches=nerf["nerf_importance"],
        launches_by_path={"nerf_stage": nerf["nerf_importance"]},
        plain_launches=nerf["nerf_importance_reference"],
        shape=f"{row['rays']}_rays_{row['samples']}_samples_{row['targets']}_targets",
        kernel="nerf_importance_kernel", registers=row["registers"],
        entries_differ=row["entries_differ"], **{k: row[k] for k in keys}))
    kernels.append(dict(
        name="sphere_trace_step", route="cuda", source="volsurfs_tpu_torch/csrc/sphere_trace.cu",
        replaces="volsurfs_tpu/ops/sphere_tracing.py:161", launches=surf_bg["sphere_trace_step"],
        launches_by_path={"surf_bg_stage": surf_bg["sphere_trace_step"]},
        plain_launches=surf_bg["sphere_trace_step_reference"],
        shape=f"{k9['rays']}_rays_{k9['active']}_active_{k9['case']}",
        kernel="sphere_trace_step_kernel",
        registers=k9["registers"], entries_differ=k9["entries_differ"],
        **{k: k9[k] for k in keys}))
    kernels.append(dict(
        name="bg_samples", route="cuda", source="volsurfs_tpu_torch/csrc/bg_samples.cu",
        replaces="volsurfs_tpu/ops/samplers.py:247",
        launches=surf_bg["bg_samples"] + volsurfs_bg["bg_samples"],
        launches_by_path={"surf_bg_stage": surf_bg["bg_samples"],
                          "volsurfs_bg_stage": volsurfs_bg["bg_samples"]},
        plain_launches=surf_bg["bg_samples_reference"] + volsurfs_bg["bg_samples_reference"],
        shape=f"{k10['rays']}_rays_{k10['samples']}_samples", kernel="bg_samples_kernel",
        registers=k10["registers"], entries_differ=k10["entries_differ"],
        **{k: k10[k] for k in keys}))
    print(json.dumps({"kernels": kernels}), flush=True)
    for k in kernels:
        if (k["launches"] <= 0 or k["plain_launches"] != 0
                or min(k["launches_by_path"].values()) <= 0):
            raise AssertionError(f"a main path did not run {k['name']} as a kernel: {k}")
        if k["registers"] is None:
            raise AssertionError(f"ptxas reported no registers for {k['name']}: {resources}")
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
