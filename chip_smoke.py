#!/usr/bin/env python3
"""Smoke run of the torch port (volsurfs_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's volsurfs slice at the width of config/volsurfs/base_5.cfg
on the five committed shells in runs/pipeline_tpu_256/volsurfs/meshes/:

1. the card's name and power limit;
2. builds the CUDA kernels (one nvcc per csrc/*.cu source, in parallel) and
   the native BVH builder (g++) into volsurfs_tpu_torch/_build/, with each
   kernel's registers and spills as ptxas reports them;
3. kernel K1 (table-gradient scatter-add) against its plain version at the
   train step's shape and at a collision-heavy one, with times;
4. kernel K2 (k-shell BVH trace) against its plain version, bit for bit,
   at three shapes: the train step's 5 x 512 rays (drawn from the tensor
   reel), one 16,384-ray render chunk and a whole 256x256 frame, with times
   (inputs and timers from volsurfs_tpu_torch/kernel_bench.py, the scene
   from volsurfs_tpu_torch/datasets/sphere_scene.py);
5. 60 train steps of 512 rays on the procedural sphere scene, the last 3
   under torch.profiler (device-busy time, launches, idle share);
6. a 256x256 test frame rendered in 16384-ray chunks, its PSNR and rate,
   and one more frame under the profiler;
7. the launches of both kernels over phases 5-6 (each must be > 0, and the
   plain versions must not have run there).

Each phase prints one JSON line. The line before the last is the kernel
table; the last line is {"ok": true, "device": {...}}. Any failure raises
and exits non-zero; a watchdog turns a hang into a traceback and an exit
after 480 s. Needs a CUDA device; imports nothing of JAX.
"""

import faulthandler

faulthandler.dump_traceback_later(480, exit=True)

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(REPO, "config", "volsurfs", "base_5.cfg")

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# operations counted for the trace bound: one slab box test of an inner
# node, one Moller-Trumbore test of a real leaf triangle (fmas counted as
# two)
BOX_TEST_FLOPS = 24
TRIANGLE_TEST_FLOPS = 50

TRAIN_STEPS = 60
WARMUP_STEPS = 10
PROFILED_STEPS = 3

_T0 = time.perf_counter()


def emit(phase, **fields):
    print(json.dumps({"phase": phase, "t_s": round(time.perf_counter() - _T0, 3), **fields}),
          flush=True)


def profiled(fn, reps):
    """fn() run reps times under torch.profiler (CPU and CUDA activity).
    Returns per call: host wall ms (ending in a synchronize), device-busy
    ms (the sum of kernel times; one stream, so kernels do not overlap),
    kernel launches, the device's idle share of the wall time, and the five
    kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from volsurfs_tpu_torch.kernel_bench import device_kernels

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / reps
    kernels = device_kernels(prof)
    busy_ms = sum(e.device_time for e in kernels) / 1e3 / reps
    by_name = {}
    for e in kernels:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.device_time / 1e3 / reps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, kernels=len(kernels) / reps,
                idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
                top_kernels_ms=[[n, round(v, 4)] for n, v in top])


def reset_counts():
    from volsurfs_tpu_torch.ops import bvh, scatter_add

    for counts in (bvh.launches, scatter_add.launches):
        for key in counts:
            counts[key] = 0


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card")
    if not os.path.isdir(os.path.join(REPO, "volsurfs_tpu_torch")):
        raise SystemExit(f"chip_smoke: no volsurfs_tpu_torch package beside {__file__}")
    from volsurfs_tpu_torch.kernel_bench import card

    smi = card()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, torch_name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    return name, smi


def phase_build():
    from volsurfs_tpu_torch import _build

    t = time.perf_counter()
    _build.kernels()
    t_nvcc = time.perf_counter() - t
    t = time.perf_counter()
    _build.bvh_builder()
    resources = _build.kernel_resources()
    emit("build", nvcc_s=round(t_nvcc, 3), gxx_s=round(time.perf_counter() - t, 3),
         ptxas=resources)
    return resources


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


def phase_trace(device, shells, reel):
    """K2 against its plain version on every shell x the rays of each of
    the three shapes (the train step's drawn from reel): every output bit
    for bit, no cursor over its step cap. Returns each shape's result."""
    from volsurfs_tpu_torch import kernel_bench as kb
    from volsurfs_tpu_torch.ops import bvh as B

    t = time.perf_counter()
    stacked = B.stack_bvhs([B.build_bvh(v, f) for v, f, _ in shells], device)
    build_s = time.perf_counter() - t
    table_bytes = sum(x.numel() * x.element_size() for x in (stacked.nodes, stacked.tris))
    node_bytes, tri_bytes = stacked.nodes[0].nbytes, stacked.tris[0].nbytes
    meshes = [(v, f) for v, f, _ in shells]
    results = {}
    for shape, (rays_o, rays_d) in kb.k2_rays(device, reel).items():
        out = B.trace_all(stacked, rays_o, rays_d)
        ref, work = B.trace_all_reference(stacked, rays_o, rays_d, return_work=True)
        stacked.check_step_cap()
        unequal = [key for key in ("is_hit", "depth", "positions", "barycentric", "triangles_id")
                   if not torch.equal(out[key], ref[key])]
        depth_err = float((out["depth"] - ref["depth"]).abs().max())
        bary_err = float((out["barycentric"] - ref["barycentric"]).abs().max())
        fn = lambda: B.trace_all(stacked, rays_o, rays_d)  # noqa: E731
        ms, kernel_device_ms = kb.time_ms(fn), kb.device_ms(fn)
        plain_ms = kb.time_ms(lambda: B.trace_all_reference(stacked, rays_o, rays_d),
                              reps=3, warmup=1)
        stacked.check_step_cap()
        k, R = stacked.node_begin.shape[0], rays_o.shape[0]
        # the nodes and triangles these rays read, rays in, (t, id, u, v) out
        nbytes = (work["nodes_read"] * node_bytes + work["triangles_read"] * tri_bytes
                  + 24 * R + 16 * k * R)
        flops = (work["box_tests"] * BOX_TEST_FLOPS
                 + work["triangle_tests"] * TRIANGLE_TEST_FLOPS)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        results[shape] = dict(
            shape=shape, shells=k, rays=R, nodes=int(stacked.nodes.shape[0]),
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
        emit("k2_bvh_trace", **results[shape])
        if unequal or results[shape]["step_cap_overflows"]:
            raise AssertionError(f"K2 disagrees with its plain version: {results[shape]}")
    return results


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


def phase_train(device, shells, reel, hp, steps=TRAIN_STEPS):
    from volsurfs_tpu_torch.datasets.tensor_reel import get_next_rays_batch
    from volsurfs_tpu_torch.methods.volsurfs import VolSurfs
    from volsurfs_tpu_torch.ops.raycast import make_bounding_sphere

    t = time.perf_counter()
    method = VolSurfs(hp, shells, bg_color="white",
                      bounding_primitive=make_bounding_sphere(1.0), device=device, seed=0)
    n_params = sum(p.numel() for p in method.models.parameters())
    emit("train_setup", setup_s=time.perf_counter() - t, textures=len(method.models) * (hp.sh_degree + 1),
         params=n_params, rays_per_step=hp.training_rays_batch_size,
         warmup=hp.nr_warmup_iters, milestones=hp.lr_milestones, lr=hp.lr)
    gen = torch.Generator(device=device).manual_seed(0)
    losses, step_ms = [], []

    def step():
        it = len(losses)
        t = time.perf_counter()
        batch = get_next_rays_batch(reel, gen, hp.training_rays_batch_size,
                                    jitter_pixels=hp.jitter_training_rays)
        loss = float(method.train_step(batch)["loss"])
        if device.type == "cuda":
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(loss)
        if not np.isfinite(loss):
            raise AssertionError(f"train step {it}: loss {loss}")
        if (it + 1) % 10 == 0:
            emit("train", step=it + 1, loss=loss, mean_loss_last_10=float(np.mean(losses[-10:])))

    for _ in range(steps - PROFILED_STEPS):
        step()
    step_ms_unprofiled = step_ms[WARMUP_STEPS:]
    if device.type == "cuda":  # the last steps run under the profiler
        emit("train_profile", steps=PROFILED_STEPS, **profiled(step, PROFILED_STEPS))
    else:
        for _ in range(PROFILED_STEPS):
            step()
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    emit("train_done", losses=losses, mean_first_10=first, mean_last_10=last,
         median_step_ms=float(np.median(step_ms_unprofiled)),
         steps_timed=len(step_ms_unprofiled),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9 if device.type == "cuda" else None)
    if not last < first:
        raise AssertionError(f"loss did not fall: first 10 {first}, last 10 {last}")
    return method


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


def main():
    name, smi = phase_device()
    device = torch.device("cuda")
    resources = phase_build()

    from volsurfs_tpu_torch import kernel_bench as kb
    from volsurfs_tpu_torch.datasets import sphere_scene
    from volsurfs_tpu_torch.datasets.tensor_reel import make_tensor_reel
    from volsurfs_tpu_torch.ops import bvh, scatter_add

    k1 = phase_scatter_add(device)
    shells = sphere_scene.load_shells()
    reel = make_tensor_reel(*sphere_scene.train_split(), device=device)
    k2_shapes = phase_trace(device, shells, reel)
    k2 = k2_shapes[f"frame_5x{sphere_scene.FRAME ** 2}"]

    rays_o, rays_d, gt = sphere_scene.test_camera(device)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the main path: train, then render
    method = phase_train(device, shells, reel, smoke_hyper_params())
    method.stacked_bvh.check_step_cap()
    phase_render(device, method, rays_o, rays_d, gt, kb.CHUNK)
    method.stacked_bvh.check_step_cap()
    counts = {**scatter_add.launches, **bvh.launches}

    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        dict(name="scatter_add_rows", route="cuda",
             source="volsurfs_tpu_torch/csrc/scatter_add.cu",
             replaces="volsurfs_tpu/ops/pallas/scatter_add.py:107",
             launches=counts["scatter_add"], plain_launches=counts["scatter_add_reference"],
             shape="hashgrid_backward",
             registers=resources.get("scatter_add_rows_f2_kernel", {}).get("registers"),
             **{k: k1[k] for k in keys}),
        dict(name="bvh_trace", route="cuda",
             source="volsurfs_tpu_torch/csrc/bvh_trace.cu",
             replaces="volsurfs_tpu/ops/bvh.py:490",
             launches=counts["bvh_trace"], plain_launches=counts["bvh_trace_reference"],
             shape=k2["shape"],
             registers=resources.get("bvh_trace_kernel", {}).get("registers"),
             **{k: k2[k] for k in keys}),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    for k in kernels:
        if k["launches"] <= 0 or k["plain_launches"] != 0:
            raise AssertionError(f"main path did not run {k['name']} as a kernel: {k}")
        if k["registers"] is None:
            raise AssertionError(f"ptxas reported no registers for {k['name']}: {resources}")
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
