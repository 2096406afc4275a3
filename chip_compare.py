#!/usr/bin/env python3
"""Run chip_smoke.py of another checkout of the port and of this one on the
same card, in turns, so that their numbers can be compared.

    python3 chip_compare.py OTHER_CHECKOUT OUT_DIR

OTHER_CHECKOUT is an unpacked tree of an earlier commit (for example
``git archive <commit> | tar -x -C _proof/parent``). The two run in the
order other, this, this, other, each in its own process, with their logs
in OUT_DIR. The other tree is measured with this tree's timers: its
``volsurfs_tpu_torch/kernel_bench.py`` is replaced by this one's and its
chip_smoke's ``profiled`` by this one's, so that both time and profile
alike; its kernels are its own. Prints each run's train, kernel,
orbit and quality lines. Needs a CUDA card.
"""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = tuple('{"phase": "%s"' % p for p in (
    "build", "train_done", "train_profile", "k4_shade", "baked_orbit",
    "baked_orbit_profile", "baked_quality")) + ('{"kernels"',)

# runs the other tree's chip_smoke.main() with this tree's profiled()
BOOTSTRAP = """
import importlib.util, sys
sys.path.insert(0, {other!r})
spec = importlib.util.spec_from_file_location("this_smoke", {this!r})
this = importlib.util.module_from_spec(spec)
spec.loader.exec_module(this)
import chip_smoke
chip_smoke.profiled = this.profiled
sys.exit(chip_smoke.main())
"""


def run(label, cmd, cwd, out_dir, i):
    log = os.path.join(out_dir, f"{i}_{label}.log")
    with open(log, "w") as out, open(log + ".err", "w") as err:
        rc = subprocess.run(cmd, cwd=cwd, stdout=out, stderr=err, timeout=900).returncode
    print(f"== run {i}: {label}, exit {rc}", flush=True)
    with open(log) as f:
        for line in f:
            if line.startswith(PHASES):
                print(line.rstrip()[:2500], flush=True)
    return rc


def main():
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    other, out_dir = (os.path.abspath(a) for a in sys.argv[1:])
    os.makedirs(out_dir, exist_ok=True)
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
