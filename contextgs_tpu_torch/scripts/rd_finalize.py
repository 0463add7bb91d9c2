"""End of a rate-distortion queue (port of the root `scripts/r5_finalize.sh`):
every point encoded again from its newest checkpoint and its decoded scene
rendered, the coder audited per point, the RD table, the bench.

For each `<out>/l{λ:g}/` of the shell script's λ (0.004, 0.0005, 0.001,
0.002) that holds a training checkpoint (the port's `chkpnt{it}.pt` or
the JAX package's `chkpnt{it}.pkl`): the test driver, `python -m
contextgs_tpu_torch.drivers.test -s <out>/scene -m <dir>`
("ours_from_ckpt" in its results.json), then `python -m
contextgs_tpu_torch.scripts.codec_diag -m <dir> --out
<dir>/codec_diag.json`. Then `scripts.rd_table --out <out>` and
`drivers.bench`. Each is a process of its own started from the
repository's root, under the shell script's time limit (1800, 1200, 300
and 900 s), its output appended to `<out>/rd_finalize.log` after a
`=== <step> <date> ===` line.

The shell script's first line runs the JAX package's golden kernel tests
on the TPU (`pytest -m tpu`). The port's counterpart on the card is
`python3 chip_smoke.py` at the root of the checkout, which builds every
kernel and holds each against its plain version; nothing runs in its
place here.

`--dry_run` prints the steps, each as `timeout <s> <command>`, and runs
nothing (it needs no card). `--no_bench` leaves the bench out, where it
ran already. `--force_cpu` goes to the test driver,
codec_diag and the bench; without it they run on the CUDA card, and the
script raises where there is none.

    python -m contextgs_tpu_torch.scripts.rd_finalize [--out outputs/r4_bench]
        [--dry_run] [--no_bench] [--force_cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.drivers.test import newest_checkpoint
from contextgs_tpu_torch.scripts import run_steps, show_steps

LMBDAS = (0.004, 0.0005, 0.001, 0.002)
TIMEOUT = dict(test=1800, codec_diag=1200, rd_table=300, bench=900)
MODULE = dict(test="contextgs_tpu_torch.drivers.test",
              codec_diag="contextgs_tpu_torch.scripts.codec_diag",
              rd_table="contextgs_tpu_torch.scripts.rd_table",
              bench="contextgs_tpu_torch.drivers.bench")


def plan(out: str, force_cpu: bool = False, bench: bool = True):
    """(the steps, the notes for points without a checkpoint): each step
    (label, argv after `python`, time limit in seconds); the bench last,
    unless `bench` is false."""
    dev = ["--force_cpu"] if force_cpu else []
    scene = os.path.join(out, "scene")
    steps, notes = [], []
    for lm in LMBDAS:
        run = os.path.join(out, f"l{lm:g}")
        if not os.path.isdir(run):
            continue
        if newest_checkpoint(run) is None:
            notes.append(f"no ckpt in {run}")
            continue
        steps.append((f"test l{lm:g}", ["-m", MODULE["test"], "-s", scene,
                                        "-m", run, *dev], TIMEOUT["test"]))
        steps.append((f"codec_diag l{lm:g}",
                      ["-m", MODULE["codec_diag"], "-m", run, "--out",
                       os.path.join(run, "codec_diag.json"), *dev],
                      TIMEOUT["codec_diag"]))
    steps.append(("rd_table", ["-m", MODULE["rd_table"], "--out", out],
                  TIMEOUT["rd_table"]))
    if bench:
        steps.append(("final bench", ["-m", MODULE["bench"], *dev],
                      TIMEOUT["bench"]))
    return steps, notes


def main(argv=None) -> int:
    """Run the steps in order; → 0 where every step exited 0, else 1 (a
    failed step does not stop the ones after it, as in the shell
    script)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join("outputs", "r4_bench"))
    p.add_argument("--dry_run", action="store_true",
                   help="print the steps and run nothing")
    p.add_argument("--force_cpu", action="store_true",
                   help="run the test driver, codec_diag and the bench on "
                        "the CPU")
    p.add_argument("--no_bench", action="store_true",
                   help="leave out the final bench (where it ran already)")
    args = p.parse_args(argv)
    if not args.dry_run:
        resolve_device("cpu" if args.force_cpu else None)
    out = os.path.abspath(args.out)
    steps, notes = plan(out, args.force_cpu, not args.no_bench)
    if args.dry_run:
        for text in notes:
            print(f"# {text}")
        show_steps(steps)
        return 0

    log_path = os.path.join(out, "rd_finalize.log")
    with open(log_path, "a") as f:
        f.writelines(f"{text}\n" for text in notes)
    ok = run_steps(steps, log_path)
    with open(log_path, "a") as f:
        f.write(f"=== finalize done {time.ctime()} ===\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
