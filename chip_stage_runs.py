"""Repeats chip_smoke.py's main paths surf_stage and offsets_stage on one
CUDA card, to see how the offsets_surfs stage's test psnr spreads with the
cut of its schedule.

    python3 chip_stage_runs.py RUNS SCALES WORKERS OUT_DIR

runs phases 14-17 of chip_smoke.py (the surf stage, then the offsets_surfs
stage from its SDF) RUNS times at each comma-separated cut of the
offsets_surfs schedule in SCALES (for example 0.02,0.04; chip_smoke.py
runs OFFSETS_SCALE), each run in its own process and WORKERS at once on
the card (both stages are host-bound), with their logs in OUT_DIR. The
runs skip the stages' profiled steps (the tracer would see the other runs'
kernels) and the K6 and K7 phases before them. Prints a line a run (its
test psnrs, the occupancy refreshes with their variance and beta, each
phase's losses), then a line a scale; exits 1 if any run failed its bars.
No run is retried. Imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys
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


def stage_run(scale):
    """One run of the surf and offsets_surfs main paths, the offsets_surfs
    schedule cut by scale (a child of main)."""
    import torch

    chip_smoke = _chip_smoke()
    chip_smoke.OFFSETS_SCALE = scale
    chip_smoke.profiled = lambda *args, **kwargs: {}
    chip_smoke.phase_permuto = chip_smoke.phase_occupancy_sampler = lambda *args: None
    from volsurfs_tpu_torch.datasets.mvdataset import MVDataset

    device = torch.device("cuda")
    mv = MVDataset("synthetic", "sphere", "", config=chip_smoke.STAGE_DATA)
    _, _, _, sdf_state, _ = chip_smoke.phase_surf(device, None, mv, None)
    chip_smoke.phase_offsets(device, mv, sdf_state)
    return 0


def _line(log, phase):
    with open(log) as f:
        return next((json.loads(line) for line in f
                     if line.startswith('{"phase": "%s"' % phase)), None)


def main():
    if sys.argv[1:2] == ["--run"]:
        return stage_run(float(sys.argv[2]))
    if len(sys.argv) != 5:
        raise SystemExit(__doc__)
    runs, workers, out_dir = int(sys.argv[1]), int(sys.argv[3]), sys.argv[4]
    scales = [float(x) for x in sys.argv[2].split(",")]
    bar = _chip_smoke().OFFSETS_PSNR_BAR
    from volsurfs_tpu_torch import _build

    _build.kernels()  # once, before the children load the libraries
    os.makedirs(out_dir, exist_ok=True)
    queue = [(i, scale) for i in range(runs) for scale in scales]
    running, results = [], {scale: [] for scale in scales}
    env = dict(os.environ, OMP_NUM_THREADS="2")
    while queue or running:
        while queue and len(running) < workers:
            i, scale = queue.pop(0)
            log = os.path.join(out_dir, f"stage_{scale:g}_{i}.log")
            with open(log, "w") as out:
                proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--run",
                                         repr(scale)], stdout=out, stderr=subprocess.STDOUT,
                                        cwd=REPO, env=env)
            running.append((i, scale, log, proc, time.perf_counter()))
        time.sleep(1.0)
        for job in list(running):
            i, scale, log, proc, t0 = job
            if proc.poll() is None and time.perf_counter() - t0 < RUN_LIMIT_S:
                continue
            if proc.poll() is None:
                proc.kill()
            rc = proc.wait()
            running.remove(job)
            surf, offsets = _line(log, "surf_eval"), _line(log, "offsets_eval")
            train = _line(log, "offsets_train") or {}
            line = dict(stage_run=i, scale=scale, rc=rc, seconds=time.perf_counter() - t0,
                        surf_psnr=surf and surf["psnr"], offsets_psnr=offsets and offsets["psnr"],
                        refreshes=train.get("refreshes"),
                        phases={k: {f: v[f] for f in ("first", "last", "mean_last_5")}
                                for k, v in train.get("phases", {}).items()})
            results[scale].append(line)
            print(json.dumps(line), flush=True)
    failed = 0
    for scale, lines in results.items():
        psnr = [r["offsets_psnr"] for r in lines if r["offsets_psnr"] is not None]
        bad = [r["stage_run"] for r in lines if r["rc"] != 0]
        failed += len(bad)
        print(json.dumps(dict(scale=scale, runs=len(lines), failed_runs=bad,
                              bar_psnr=bar, offsets_psnr=sorted(psnr),
                              median=statistics.median(psnr) if psnr else None,
                              min=min(psnr, default=None))), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
