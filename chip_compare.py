#!/usr/bin/env python3
"""Run chip_smoke.py of another checkout of the port and of this one on the
same card, in turns, so that their numbers can be compared.

    python3 chip_compare.py OTHER_CHECKOUT OUT_DIR
    python3 chip_compare.py OTHER_CHECKOUT OUT_DIR --surf-pairs N

OTHER_CHECKOUT is an unpacked tree of an earlier commit (for example
``git archive <commit> | tar -x -C _proof/parent``). The two run in the
order other, this, this, other, each in its own process, with their logs
in OUT_DIR; after each, ``python -m volsurfs_tpu_torch.kernel_bench k6
k7 k8 k9 k10`` in the same tree (K6's forward without saving, and one
lookup's forward and backward; K7 at the train steps' and a render chunk's
rays; K8's kernels at the surf and offsets_surfs steps' and the surf eval
chunk's shapes; K9's step and a whole trace of a 256^2 frame; K10 at its
four path shapes; all through the public wrappers). The
other tree is measured with this tree's timers: its
``volsurfs_tpu_torch/kernel_bench.py`` is replaced by this one's and its
chip_smoke's ``profiled`` by this one's, so that both time and profile
alike, and its offsets_surfs stage runs this one's cut of the schedule
(``OFFSETS_SCALE``), so that both profile steps of one training state;
its kernels are its own. Prints each run's train, kernel,
orbit, quality, surf- and offsets_surfs-stage lines. Needs a CUDA card.

With ``--surf-pairs N`` it runs only the surf stage's training
(chip_smoke's ``phase_surf_train``: 100 sphere-init and 300 data steps
through Trainer.train) of each tree, in N pairs that alternate which tree
goes first, and prints each run's median step times and then each tree's
medians over its runs: the host-bound data step spreads too widely
between runs for two runs a tree to tell trees apart.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = tuple('{"phase": "%s"' % p for p in (
    "build", "train_done", "train_profile", "k4_shade", "baked_orbit",
    "baked_orbit_profile", "baked_quality", "k6_permuto", "surf_train", "surf_eval",
    "k7_occupancy_sampler", "surf_train_profile", "surf_stage_launches", "k8_volrender",
    "offsets_train",
    "offsets_eval", "offsets_train_profile", "offsets_stage_launches", "surf_bg_traced",
    "k10_bg_samples", "k9_sphere_trace_step", "sphere_trace_loop")) + (
    '{"kernels"', '{"bench"')

# runs the other tree's chip_smoke.main() with this tree's profiled() and
# offsets_surfs cut
BOOTSTRAP = """
import importlib.util, sys
sys.path.insert(0, {other!r})
spec = importlib.util.spec_from_file_location("this_smoke", {this!r})
this = importlib.util.module_from_spec(spec)
spec.loader.exec_module(this)
import chip_smoke
chip_smoke.profiled = this.profiled
chip_smoke.OFFSETS_SCALE = this.OFFSETS_SCALE
sys.exit(chip_smoke.main())
"""


def run(label, cmd, cwd, out_dir, i):
    log = os.path.join(out_dir, f"{i}_{label}.log")
    bench = [sys.executable, "-m", "volsurfs_tpu_torch.kernel_bench", "k6", "k7", "k8", "k9",
             "k10"]
    with open(log, "w") as out, open(log + ".err", "w") as err:
        rc = subprocess.run(cmd, cwd=cwd, stdout=out, stderr=err, timeout=900).returncode
        rc = max(rc, subprocess.run(bench, cwd=cwd, stdout=out, stderr=err,
                                    timeout=300).returncode)
    print(f"== run {i}: {label}, exit {rc}", flush=True)
    with open(log) as f:
        for line in f:
            if line.startswith(PHASES):
                print(line.rstrip()[:2500], flush=True)
    return rc


# runs chip_smoke.phase_surf_train of the tree in the working directory
SURF_ONLY = """
import json, tempfile, torch, chip_smoke
from volsurfs_tpu_torch.datasets.mvdataset import MVDataset
mv = MVDataset("synthetic", "sphere", "", config=chip_smoke.STAGE_DATA)
with tempfile.TemporaryDirectory(prefix="vs_surf_pairs_") as run_dir:
    chip_smoke.phase_surf_train(torch.device("cuda"), mv, run_dir)
"""


def surf_pairs(other, out_dir, pairs):
    medians = {"other": [], "this": []}
    for i in range(pairs):
        for label in (("other", "this") if i % 2 == 0 else ("this", "other")):
            cwd = other if label == "other" else REPO
            log = os.path.join(out_dir, f"surf_{i}_{label}.log")
            with open(log, "w") as out, open(log + ".err", "w") as err:
                rc = subprocess.run([sys.executable, "-c", SURF_ONLY], cwd=cwd, stdout=out,
                                    stderr=err, timeout=600).returncode
            if rc:
                print(f"== pair {i}: {label}, exit {rc}", flush=True)
                return rc
            with open(log) as f:
                line = next(json.loads(l) for l in f if l.startswith('{"phase": "surf_train"'))
            ms = (line["sphere_init"]["median_step_ms"], line["data"]["median_step_ms"])
            medians[label].append(ms)
            print(json.dumps({"pair": i, "tree": label, "sphere_init_median_ms": ms[0],
                              "data_median_ms": ms[1]}), flush=True)
    for label, runs in medians.items():
        print(json.dumps({"tree": label, "runs": len(runs),
                          "sphere_init_median_ms": statistics.median(r[0] for r in runs),
                          "data_median_ms": statistics.median(r[1] for r in runs)}), flush=True)
    return 0


def main():
    if len(sys.argv) not in (3, 5) or (len(sys.argv) == 5 and sys.argv[3] != "--surf-pairs"):
        raise SystemExit(__doc__)
    other, out_dir = (os.path.abspath(a) for a in sys.argv[1:3])
    os.makedirs(out_dir, exist_ok=True)
    if len(sys.argv) == 5:
        return surf_pairs(other, out_dir, int(sys.argv[4]))
    shutil.copyfile(os.path.join(REPO, "volsurfs_tpu_torch", "kernel_bench.py"),
                    os.path.join(other, "volsurfs_tpu_torch", "kernel_bench.py"))
    this_smoke = os.path.join(REPO, "chip_smoke.py")
    runs = {
        "other": ([sys.executable, "-c", BOOTSTRAP.format(other=other, this=this_smoke)], other),
        "this": ([sys.executable, this_smoke], REPO),
    }
    rcs = [run(label, *runs[label], out_dir, i)
           for i, label in enumerate(("other", "this", "this", "other"))]
    return max(rcs)


if __name__ == "__main__":
    sys.exit(main())
