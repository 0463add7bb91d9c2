"""Readings that set the limits of `correct`, many seeds in one process:

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 \
        --mode program|control|fault:<name> [--seconds 1] [--look]

`program`: the numbers compared of sound runs of the program (each a run
of the cell with a short window); `repeat`: two sound runs of each seed,
the second's numbers against the first's in place of the reference's (a
kind with `readings(got, ref)`); `control`: those of the plain reference
put in the program's place in TF32, a step below the float32 the
configuration states (no program runs); `fault:<name>`: those of runs
with that fault of the kind's `FAULTS` planted in the program. `--look`
keeps whole tensors where the kind can look inside a reading (a training
cell: the worst-changed leaf's elements split by the reference's
gradient). Prints one JSON line a seed, with every candidate number of
the kind, and the largest and smallest reading of each number.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--look", action="store_true")
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton")
    sys.path.insert(0, str(REPO))

    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cell = harness.load_cell(REPO, args.workload, False)
    kind = harness.kind_module(cell.traffic["kind"])
    readings = []
    for seed in (int(s) for s in args.seeds.split(",")):
        jobs = []
        if args.mode == "repeat":
            runs = []
            for _ in range(2):
                def keep(job):
                    job.keep_full = args.look
                    runs.append(job)
                harness.run_cell(cell, seed, args.seconds, False, dev,
                                 job_hook=keep)
            values = runs[1].readings(runs[1].captured, runs[0].captured)
            print(json.dumps({"workload": args.workload, "mode": args.mode,
                              "seed": seed, "readings": values,
                              "details": runs[1].details}), flush=True)
            readings.append(values)
            del runs
            continue
        if args.mode == "control":
            jobs.append(kind.Job(cell.config, cell.traffic, seed, dev))
            jobs[0].keep_full = args.look
            checks = jobs[0].checks(control=True)
        else:
            faults = ([args.mode.split(":", 1)[1]]
                      if args.mode.startswith("fault:") else [])

            def hook(job, faults=faults):
                job.faults = faults
                job.keep_full = args.look
                jobs.append(job)
            _, checks = harness.run_cell(cell, seed, args.seconds, False,
                                         dev, job_hook=hook)
        values = {k: v for k, (v, _) in checks.items()}
        job = jobs[0]
        if hasattr(job, "every"):
            values = dict(job.every, **values)
        readings.append(values)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "readings": values,
                          "details": getattr(job, "details", None)}),
              flush=True)
        del jobs
        torch.cuda.empty_cache()
    for name in readings[0]:
        vals = [r[name] for r in readings]
        print(json.dumps({"number": name, "mode": args.mode,
                          "seeds": len(vals), "min": min(vals),
                          "max": max(vals)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
