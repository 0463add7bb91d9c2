"""A measurement session on the card, then the rate-distortion queue (port
of the root `scripts/r5_chip_session.sh`).

It waits as `scripts.rd_queue` does, until no training run of the port
holds the card, so that the measurements run on a quiet card. Then, each a process of its own started from the
repository's root under the shell script's time limit, its output
appended to `--log` (default `<out>/chip_session.log`) after a
`=== <step> <date> ===` line:

    drivers.bench                                      900 s
    scripts.corner_diag                                900 s
    scripts.fps_bench --anchors 100000 --views 32     1500 s
    scripts.thr_sweep --iters 15                      2700 s

and last `scripts.rd_queue --out <out> --deadline_ts <deadline>` (the
queue waits and skips by that deadline itself; default five hours from
now), with no time limit of its own.

`--dry_run` prints the steps, each as `timeout <s> <command>` (the queue
without `timeout`), and runs nothing (it needs no card). `--force_cpu`
goes to every step; without it they run on the CUDA card, and the session
raises where there is none.

    python -m contextgs_tpu_torch.scripts.chip_session [--out outputs/r4_bench]
        [--log <file>] [--deadline_ts <epoch s>] [--dry_run] [--force_cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.scripts import rd_queue, run_steps, show_steps

SESSION_SECONDS = 18_000      # the default deadline, from now
MEASUREMENTS = (
    ("bench baseline", ["-m", "contextgs_tpu_torch.drivers.bench"], 900),
    ("corner_diag", ["-m", "contextgs_tpu_torch.scripts.corner_diag"], 900),
    ("fps_bench", ["-m", "contextgs_tpu_torch.scripts.fps_bench",
                   "--anchors", "100000", "--views", "32"], 1500),
    ("thr_sweep", ["-m", "contextgs_tpu_torch.scripts.thr_sweep",
                   "--iters", "15"], 2700))


def plan(out: str, deadline_ts: float, force_cpu: bool = False) -> list:
    """The steps in order, each (label, argv after `python`, time limit in
    seconds or None)."""
    dev = ["--force_cpu"] if force_cpu else []
    queue = ["-m", "contextgs_tpu_torch.scripts.rd_queue", "--out", out,
             "--deadline_ts", f"{deadline_ts:.0f}"]
    return ([(label, [*cmd, *dev], timeout)
             for label, cmd, timeout in MEASUREMENTS]
            + [(f"launching RD queue, deadline {deadline_ts:.0f}",
                queue + dev, None)])


def main(argv=None) -> int:
    """Wait for the card, run the steps in order; → 0 where every step
    exited 0, else 1 (a failed step does not stop the ones after it, as in
    the shell script)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join("outputs", "r4_bench"))
    p.add_argument("--log", default=None,
                   help="the log file (default <out>/chip_session.log)")
    p.add_argument("--deadline_ts", type=float, default=None,
                   help="epoch seconds handed to the queue (default: five "
                        "hours from now)")
    p.add_argument("--dry_run", action="store_true",
                   help="print the steps and run nothing")
    p.add_argument("--force_cpu", action="store_true",
                   help="run every step on the CPU")
    args = p.parse_args(argv)
    if not args.dry_run:
        resolve_device("cpu" if args.force_cpu else None)
    out = os.path.abspath(args.out)
    deadline = (time.time() + SESSION_SECONDS if args.deadline_ts is None
                else args.deadline_ts)
    steps = plan(out, deadline, args.force_cpu)
    if args.dry_run:
        show_steps(steps)
        return 0

    log_path = os.path.abspath(args.log or os.path.join(out,
                                                        "chip_session.log"))
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    rd_queue.wait_for_card()
    with open(log_path, "a") as f:
        f.write(f"=== chip free {time.ctime()} ===\n")
    ok = run_steps(steps, log_path)
    with open(log_path, "a") as f:
        f.write(f"=== session done {time.ctime()} ===\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
