"""Repeats chip_smoke.py's main paths surf_stage and offsets_stage, or
nerf_stage, on one CUDA card, to see how a stage's test psnr spreads with
the cut of its schedule (and the offsets_surfs stage's with clipping its
rays to the occupied space).

    python3 chip_stage_runs.py RUNS SCALES WORKERS OUT_DIR [CLIP [RES]]

runs phases 14-17 of chip_smoke.py (the surf stage, then the offsets_surfs
stage from its SDF) RUNS times at each comma-separated cut of the
offsets_surfs schedule in SCALES (for example 0.02,0.04; chip_smoke.py
runs OFFSETS_SCALE; the offsets-init phase keeps OFFSETS_INIT_STEPS) and
each setting of clip_rays_to_occupancy in CLIP (on, off or on,off; default
chip_smoke.py's), each run in its own process and WORKERS at once on the
card (both stages are host-bound), with their logs in OUT_DIR (gzipped).
The runs skip the stages' profiled steps (the tracer would see the other
runs' kernels) and the K6 and K7 phases before them.

Each run logs the offsets_surfs steps' loss terms, gradient norms and ray
count from 5 steps before to 10 after every occupancy refresh
(OFFSETS_TERMS; the line ``offsets_steps``; a step's row holds the
iteration it ends at), extracts the trained model's shells at each
comma-separated grid resolution in RES (default chip_smoke.EXTRACTION_RES)
and simplifies and atlases them as chip_smoke's pipeline path does (the
line ``offsets_shells`` a resolution: each shell's raw vertices and faces,
the seconds of each step; the pipeline path needs every shell) and watches
the occupancy refreshes from the one at which the refresh's variance
reaches its cap of 0.8: when a refresh leaves less than DIP_SHARE of the
occupied share the previous one left, it saves the state from before
that refresh (every model's parameters, the grid, the iteration and the
ray count) and the ray batches of the 5 steps after it, once a run. The
SDF's parameters are kept in float32; the colour and transparency
tables in float16 and the optimizer's moments not at all, so that one
state stays under 64 MiB (three float32 tables of 3,898,240 rows and
their moments are ~281 MB). At the end the state of
the run with the lowest offsets_surfs psnr that dipped goes to
OUT_DIR/dip.npz (tests/_torch_offsets_replay.py replays it on the CPU
against the JAX package), the others are dropped.

Prints a line a run (its test psnrs, the refreshes with their variance and
beta, each phase's losses, whether and where it dipped), then a line a
(scale, clip); exits 1 if any run failed its bars. No run is retried.
Imports nothing of JAX.

    python3 chip_stage_runs.py nerf RUNS SCALES WORKERS OUT_DIR

runs phases 21-22 of chip_smoke.py (the main path nerf_stage, without its
profiled steps) RUNS times at each comma-separated cut of the nerf
schedule in SCALES (chip_smoke.py runs NERF_SCALE), each run in its own
process and WORKERS at once, with their logs in OUT_DIR (gzipped); prints
a line a run (the test psnr, the path's seconds, the median step, the
refreshes) and a line a scale (the psnrs, their median and range, the
runs under chip_smoke.py's bar); exits 1 if any run failed.
"""

import gzip
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
RUN_LIMIT_S = 1800


def _chip_smoke():
    """chip_smoke.py as a module, its watchdog off (main times its runs)."""
    import faulthandler

    sys.path.insert(0, REPO)
    import chip_smoke

    faulthandler.cancel_dump_traceback_later()
    return chip_smoke


# the loss terms and gradient norms logged a step
OFFSETS_TERMS = ("loss", "rgb", "eikonal_main", "eikonal_supp", "curvature", "offsets",
                 "loss_offsurface_high_sdf", "grad_norm/sdfs", "grad_norm/rgb_0",
                 "grad_norm/alpha_0")
DIP_SHARE = 0.7  # a refresh that keeps less than this of the occupied share
DIP_STEPS = 5  # the steps whose ray batches follow a dip's state
# float16 is enough for the tables the replay does not refresh through
HALF_TABLES = ("rgb_0.encoder.table", "alpha_0.encoder.table")


def _watch_dips(method, dip_path, schedule, terms):
    """Wraps method's refresh and train step: each step appends its row
    [iteration it ends at, rays, *OFFSETS_TERMS] to terms; the first
    refresh from the variance's cap on whose occupied share falls under
    DIP_SHARE of the previous refresh's saves the state before it and the
    next DIP_STEPS steps' ray batches to dip_path (a .npz), with schedule
    (the run's scale, offsets-init steps and clip setting)."""
    import numpy as np
    import torch

    cap_iter = next(i for i in range(method.hp.training_end_iter + 1)
                    if method._variance(i) >= np.float32(0.8))
    refresh, step = method.update_occupancy_grid, method.train_step
    state = dict(prev=None, saved=None, batches=[])

    def watched_refresh():
        it = method.iter_nr
        before = None
        if state["saved"] is None and it >= cap_iter:
            before = {f"{name}.{k}": v.detach().clone()
                      for name, m in method.models.items() for k, v in m.state_dict().items()}
            grid = method.grid.occupancy.clone()
        refresh()
        share = float(method.grid.occupancy_fraction())
        prev, state["prev"] = state["prev"], share
        if before is not None and prev and share < DIP_SHARE * prev:
            arrays = {"param/" + k: v.cpu().numpy().astype(
                np.float16 if k in HALF_TABLES else np.float32) for k, v in before.items()}
            arrays["grid_before"] = np.packbits(grid.cpu().numpy().reshape(-1))
            arrays["grid_after"] = np.packbits(method.grid.occupancy.cpu().numpy().reshape(-1))
            state["saved"] = dict(iter_nr=it, share_before=prev, share_after=share,
                                  cap_iter=cap_iter, schedule=schedule, arrays=arrays)

    def watched_step(batch):
        saved = state["saved"]
        if saved is not None and len(state["batches"]) < DIP_STEPS:
            state["batches"].append({k: v.cpu().numpy() for k, v in batch.items()})
        out = step(batch)
        rays = len(batch["rays_o"]) if "rays_o" in batch else 0
        terms.append([method.iter_nr, rays] + torch.stack([
            out[k].float() if k in out else torch.full((), float("nan"), device=method.device)
            for k in OFFSETS_TERMS]).tolist())
        if saved is not None and len(state["batches"]) == DIP_STEPS and "done" not in saved:
            saved["done"] = True
            arrays = saved.pop("arrays")
            for i, b in enumerate(state["batches"]):
                arrays.update({f"batch{i}/{k}": v for k, v in b.items()})
            meta = {k: v for k, v in saved.items() if k != "done"}
            arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
            np.savez_compressed(dip_path, **arrays)
            print(json.dumps({"phase": "offsets_dip_saved", "path": dip_path,
                              "bytes": os.path.getsize(dip_path), **meta}), flush=True)
        return out

    method.update_occupancy_grid, method.train_step = watched_refresh, watched_step
    return method


def stage_run(scale, clip, dip_path, resolutions):
    """One run of the surf and offsets_surfs main paths, the offsets_surfs
    schedule cut by scale, its rays clipped to the occupied space or not,
    then the trained model's shells at each of resolutions (a child of
    main)."""
    import torch

    chip_smoke = _chip_smoke()
    chip_smoke.OFFSETS_SCALE = scale
    chip_smoke.OFFSETS_CLIP_TO_OCCUPANCY = clip
    chip_smoke.profiled = lambda *args, **kwargs: {}
    chip_smoke.phase_permuto = chip_smoke.phase_occupancy_sampler = lambda *args: None
    make_offsets, offsets_train = chip_smoke.make_offsets, chip_smoke.phase_offsets_train
    terms = []

    def watched_offsets(hp, device, seed):
        method = make_offsets(hp, device, seed)
        # the trained method, not the checkpoint round trip's fresh one
        schedule = dict(scale=scale, offsets_init_steps=chip_smoke.OFFSETS_INIT_STEPS,
                        clip=clip)
        return _watch_dips(method, dip_path, schedule, terms) if seed == 0 else method

    def logged_train(*args):
        trainer = offsets_train(*args)
        # the steps from 5 before to 10 after each refresh
        refreshes = range(0, trainer.method.iter_nr, trainer.update_occupancy_every)
        steps = [[float("%.7g" % v) for v in row] for row in terms
                 if any(-5 < row[0] - r <= 10 for r in refreshes)]
        print(json.dumps({"phase": "offsets_steps", "columns": ["iter", "rays"]
                          + list(OFFSETS_TERMS), "steps": steps}), flush=True)
        return trainer

    chip_smoke.make_offsets, chip_smoke.phase_offsets_train = watched_offsets, logged_train
    from volsurfs_tpu_torch.datasets.mvdataset import MVDataset

    device = torch.device("cuda")
    mv = MVDataset("synthetic", "sphere", "", config=chip_smoke.STAGE_DATA)
    _, _, _, sdf_state, _ = chip_smoke.phase_surf(device, None, mv, None)
    _, _, method = chip_smoke.phase_offsets(device, mv, sdf_state)
    from volsurfs_tpu_torch.baking import baker

    for res in resolutions:
        t = time.perf_counter()
        raw = baker.extract_meshes_from_offsets_surfs(method, resolution=res)
        torch.cuda.synchronize()
        extract_s = time.perf_counter() - t
        t = time.perf_counter()
        shells = baker.simplify_and_atlas(raw, chip_smoke.SIMPLIFY_RATIO)
        print(json.dumps({"phase": "offsets_shells", "res": res,
                          "raw": [[len(v), len(f)] for v, f in raw],
                          "simplified": [[len(v), len(f)] for v, f, _ in shells],
                          "seconds": {"extract": extract_s,
                                      "simplify_and_atlas": time.perf_counter() - t}}),
              flush=True)
    return 0


def nerf_run(scale):
    """One run of the nerf path at the cut scale, in this process."""
    chip_smoke = _chip_smoke()
    import torch

    from volsurfs_tpu_torch.datasets.mvdataset import MVDataset

    mv = MVDataset("synthetic", "sphere", "", config=chip_smoke.STAGE_DATA)
    chip_smoke.phase_nerf(torch.device("cuda"), mv, scale, profile=False)
    return 0


def nerf_main(runs, scales, workers, out_dir):
    chip_smoke = _chip_smoke()
    from volsurfs_tpu_torch import _build

    _build.kernels()  # once, before the children load the libraries
    os.makedirs(out_dir, exist_ok=True)
    results = {scale: [] for scale in scales}

    def finished(job, log, rc, seconds):
        i, scale = job
        ev, train = _line(log, "nerf_eval") or {}, _line(log, "nerf_train") or {}
        path = _line(log, "nerf_stage_launches") or {}
        line = dict(nerf_run=i, scale=scale, rc=rc, seconds=seconds, psnr=ev.get("psnr"),
                    path_s=path.get("seconds"), median_step_ms=train.get("median_step_ms"),
                    train_s=train.get("train_s"), last_10=train.get("last_10"),
                    refreshes=train.get("refreshes"))
        results[scale].append(line)
        print(json.dumps(line), flush=True)

    _pool([((i, scale), ["--nerf-run", repr(scale)],
            os.path.join(out_dir, f"nerf_{scale:g}_{i}.log"))
           for i in range(runs) for scale in scales], workers, finished)
    failed = 0
    for scale, lines in results.items():
        psnr = sorted(r["psnr"] for r in lines if r["psnr"] is not None)
        failed += sum(r["rc"] != 0 for r in lines)
        print(json.dumps(dict(scale=scale, runs=len(lines), bar_psnr=chip_smoke.NERF_PSNR_BAR,
                              psnr=psnr, median=statistics.median(psnr) if psnr else None,
                              min=min(psnr, default=None), max=max(psnr, default=None),
                              failed_runs=[r["nerf_run"] for r in lines if r["rc"] != 0],
                              path_s=[r["path_s"] for r in lines])), flush=True)
    return 1 if failed else 0


def _pool(jobs, workers, finished):
    """Runs jobs [(key, this script's arguments, log path)], each in its own
    process, workers at once, each killed past RUN_LIMIT_S; calls
    finished(key, log, rc, seconds) as each ends, then gzips its log."""
    # several runs share the card: allocate in expandable segments so that
    # each run's cache holds less memory it does not use
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    queue, running = list(jobs), []
    while queue or running:
        while queue and len(running) < workers:
            key, argv, log = queue.pop(0)
            with open(log, "w") as out:
                proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), *argv],
                                        stdout=out, stderr=subprocess.STDOUT, cwd=REPO, env=env)
            running.append((key, log, proc, time.perf_counter()))
        time.sleep(1.0)
        for job in list(running):
            key, log, proc, t0 = job
            if proc.poll() is None and time.perf_counter() - t0 < RUN_LIMIT_S:
                continue
            if proc.poll() is None:
                proc.kill()
            rc = proc.wait()
            running.remove(job)
            finished(key, log, rc, time.perf_counter() - t0)
            with open(log, "rb") as f, gzip.open(log + ".gz", "wb") as z:
                shutil.copyfileobj(f, z)
            os.remove(log)


def _line(log, phase):
    with open(log) as f:
        return next((json.loads(line) for line in f
                     if line.startswith('{"phase": "%s"' % phase)), None)


def main():
    if sys.argv[1:2] == ["--run"]:
        return stage_run(float(sys.argv[2]), sys.argv[3] == "on", sys.argv[4],
                         [int(r) for r in sys.argv[5].split(",")])
    if sys.argv[1:2] == ["--nerf-run"]:
        return nerf_run(float(sys.argv[2]))
    if sys.argv[1:2] == ["nerf"]:
        if len(sys.argv) != 6:
            raise SystemExit(__doc__)
        return nerf_main(int(sys.argv[2]), [float(x) for x in sys.argv[3].split(",")],
                         int(sys.argv[4]), sys.argv[5])
    if len(sys.argv) not in (5, 6, 7):
        raise SystemExit(__doc__)
    runs, workers, out_dir = int(sys.argv[1]), int(sys.argv[3]), sys.argv[4]
    scales = [float(x) for x in sys.argv[2].split(",")]
    chip_smoke = _chip_smoke()
    clips = (sys.argv[5].split(",") if len(sys.argv) >= 6
             else ["on" if chip_smoke.OFFSETS_CLIP_TO_OCCUPANCY else "off"])
    res = sys.argv[6] if len(sys.argv) == 7 else str(chip_smoke.EXTRACTION_RES)
    if not set(clips) <= {"on", "off"}:
        raise SystemExit(__doc__)
    bar = chip_smoke.OFFSETS_PSNR_BAR
    from volsurfs_tpu_torch import _build

    _build.kernels()  # once, before the children load the libraries
    os.makedirs(out_dir, exist_ok=True)
    dip_dir = tempfile.mkdtemp(prefix="vs_dips_")
    settings = [(scale, clip) for scale in scales for clip in clips]
    results = {s: [] for s in settings}

    def finished(job, log, rc, seconds):
        i, scale, clip, dip = job
        surf, offsets = _line(log, "surf_eval"), _line(log, "offsets_eval")
        train, dipped = _line(log, "offsets_train") or {}, _line(log, "offsets_dip_saved")
        with open(log) as f:
            shells = [json.loads(x) for x in f if x.startswith('{"phase": "offsets_shells"')]
        line = dict(stage_run=i, scale=scale, clip=clip, rc=rc, seconds=seconds,
                    surf_psnr=surf and surf["psnr"], offsets_psnr=offsets and offsets["psnr"],
                    dip=dipped and {k: dipped[k] for k in (
                        "iter_nr", "share_before", "share_after", "bytes")},
                    shells={s["res"]: dict(
                        shells=sum(min(vf) > 10 for vf in s["simplified"]),
                        seconds=s["seconds"]) for s in shells},
                    largest_refresh_fall=train.get("largest_refresh_fall"),
                    refreshes=train.get("refreshes"),
                    phases={k: {f: v[f] for f in ("first", "last", "mean_last_5")}
                            for k, v in train.get("phases", {}).items()})
        results[(scale, clip)].append(dict(line, dip_path=dipped and dip))
        print(json.dumps(line), flush=True)
        _keep_worst_dip(results, out_dir)

    jobs = []
    for i in range(runs):
        for scale, clip in settings:
            name = f"stage_{scale:g}_clip_{clip}_{i}"
            dip = os.path.join(dip_dir, name + ".npz")
            jobs.append(((i, scale, clip, dip), ["--run", repr(scale), clip, dip, res],
                         os.path.join(out_dir, name + ".log")))
    _pool(jobs, workers, finished)
    failed = 0
    for (scale, clip), lines in results.items():
        psnr = [r["offsets_psnr"] for r in lines if r["offsets_psnr"] is not None]
        bad = [r["stage_run"] for r in lines if r["rc"] != 0]
        failed += len(bad)
        print(json.dumps(dict(scale=scale, clip=clip, runs=len(lines), failed_runs=bad,
                              bar_psnr=bar, offsets_psnr=sorted(psnr),
                              median=statistics.median(psnr) if psnr else None,
                              min=min(psnr, default=None),
                              dipped=[r["stage_run"] for r in lines if r["dip"]],
                              shells=[r["shells"] for r in lines],
                              under_bar=[r["stage_run"] for r in lines
                                         if r["offsets_psnr"] is not None
                                         and r["offsets_psnr"] <= bar])), flush=True)
    kept = _keep_worst_dip(results, out_dir)
    if kept:
        print(json.dumps(dict(dip_kept={k: kept[k] for k in (
            "stage_run", "scale", "clip", "offsets_psnr", "dip")})), flush=True)
    shutil.rmtree(dip_dir)
    return 1 if failed else 0


def _keep_worst_dip(results, out_dir):
    """Copies the saved state of the lowest-scoring run that dipped so far
    (a run that failed before its eval scores lowest) to OUT_DIR/dip.npz,
    as the runs end, so that a call cut short keeps one. Returns its line."""
    dipped = [r for lines in results.values() for r in lines if r["dip_path"]]
    if not dipped:
        return None
    worst = min(dipped, key=lambda r: (r["offsets_psnr"] is not None, r["offsets_psnr"] or 0.0))
    target = os.path.join(out_dir, "dip.npz")
    if worst.get("kept_as") != target:
        shutil.copy(worst["dip_path"], target)
        for r in dipped:
            r.pop("kept_as", None)
        worst["kept_as"] = target
    return worst


if __name__ == "__main__":
    sys.exit(main())
