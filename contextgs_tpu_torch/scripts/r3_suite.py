"""Rate-point suite (port of the root `scripts/r3_suite.py`): one synthetic
scene, then a full training run per λ, each appending a line to
`<out>/summary.jsonl`.

The scene (512x512, 120 cameras, 80k ground-truth gaussians, 120k SfM
points by default) is made once, by
`python -m contextgs_tpu_torch.scripts.make_synth_scene`, unless `--scene`
names one. Each λ then trains in `<out>/l{λ:g}/` through
`python -m contextgs_tpu_torch.drivers.train` (estimate, encode, decode,
render the test views from the decoded scene, results.json), each a
process of its own started from the repository's root, its output
appended to `<out>/suite.log`. The layout is the one `scripts.rd_table`
reads.

Each summary entry holds `lmbda`, `iters`, `wall_s`, `rc` (the run's exit
code, or "killed"), `last_progress` (the run's progress.json, where there
is one) and `results` (its results.json, after an exit code 0). A λ whose
results.json exists is skipped, so a stopped suite restarts where it
stopped; a SIGTERM is turned into an exception so that the run it stops
is still recorded, as "killed". `--extra_flags` go to every run unchanged;
the train driver refuses the flags it refuses (`--train_vis_cap`,
`--budget`, with the reason). `--force_cpu` goes to both children; without
it the suite runs on the CUDA card or raises before it starts anything.

    python -m contextgs_tpu_torch.scripts.r3_suite [--out outputs/r3_bench]
        [--iters 30000] [--lmbdas 0.001,0.004,0.0005,0.002]
        [--extra_flags '...'] [--force_cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.scripts import raise_interrupt, run_logged

SCENE_MAKER = ["-m", "contextgs_tpu_torch.scripts.make_synth_scene"]
TRAINER = ["-m", "contextgs_tpu_torch.drivers.train"]


def run_lambda(lm: float, args, scene: str, suite_log: str,
               summary: str, device_flags: list) -> None:
    """Train λ = lm in `<out>/l{lm:g}/` and append its summary entry, also
    when the run is stopped."""
    run_dir = os.path.join(args.out, f"l{lm:g}")
    res_path = os.path.join(run_dir, "results.json")
    t0 = time.time()
    rc = None
    try:
        rc = run_logged(
            [sys.executable, *TRAINER, "-s", scene, "-m", run_dir,
             "--iterations", str(args.iters), "--lmbda", f"{lm:g}",
             "--voxel_size", str(args.voxel_size), "--no_tensorboard"]
            + args.extra_flags.split() + device_flags, suite_log)
    finally:
        wall = time.time() - t0
        entry = dict(lmbda=lm, iters=args.iters, wall_s=round(wall, 1),
                     rc=rc if rc is not None else "killed")
        prog_path = os.path.join(run_dir, "progress.json")
        if os.path.exists(prog_path):
            with open(prog_path) as f:
                entry["last_progress"] = json.load(f)
        if rc == 0 and os.path.exists(res_path):
            with open(res_path) as f:
                entry["results"] = json.load(f)
        with open(summary, "a") as f:
            f.write(json.dumps(entry) + "\n")
        print(f"λ={lm:g}: rc={rc} in {wall:.0f}s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("outputs", "r3_bench"))
    ap.add_argument("--scene", default=None)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--cams", type=int, default=120)
    ap.add_argument("--gauss", type=int, default=80_000)
    ap.add_argument("--points", type=int, default=120_000)
    ap.add_argument("--iters", type=int, default=30_000)
    ap.add_argument("--voxel_size", type=float, default=0.01)
    ap.add_argument("--lmbdas", default="0.001,0.004,0.0005,0.002")
    ap.add_argument("--extra_flags", default="",
                    help="extra drivers.train flags, space-separated")
    ap.add_argument("--force_cpu", action="store_true",
                    help="make the scene and train on the CPU; without it "
                         "both run on the CUDA card, and the suite raises "
                         "where there is none")
    args = ap.parse_args(argv)
    resolve_device("cpu" if args.force_cpu else None)
    device_flags = ["--force_cpu"] if args.force_cpu else []

    args.out = os.path.abspath(args.out)
    os.makedirs(args.out, exist_ok=True)
    scene = os.path.abspath(args.scene or os.path.join(args.out, "scene"))
    suite_log = os.path.join(args.out, "suite.log")
    summary = os.path.join(args.out, "summary.jsonl")

    if not os.path.exists(os.path.join(scene, "sparse/0/points3D.bin")):
        rc = run_logged(
            [sys.executable, *SCENE_MAKER, "--out", scene,
             "--res", str(args.res), "--cams", str(args.cams),
             "--gauss", str(args.gauss), "--points", str(args.points)]
            + device_flags, suite_log)
        if rc != 0:
            print("scene generation FAILED", flush=True)
            return 1

    previous = signal.signal(signal.SIGTERM, raise_interrupt)
    try:
        for lm in [float(x) for x in args.lmbdas.split(",")]:
            if os.path.exists(os.path.join(args.out, f"l{lm:g}",
                                           "results.json")):
                print(f"skip λ={lm:g} (done)", flush=True)
                continue
            run_lambda(lm, args, scene, suite_log, summary, device_flags)
    finally:
        signal.signal(signal.SIGTERM, previous)
    print("suite done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
