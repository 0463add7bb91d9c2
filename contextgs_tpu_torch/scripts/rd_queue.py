"""Rate-distortion queue (port of the root `scripts/r4_branch_l2.sh`, a
queue of one point, and `scripts/r5_rd_queue.sh`): further λ points of an
RD curve, each branched from one run's checkpoint at the context
transition.

Before the context phase the schedule does not depend on λ: the rate term
λ·bit_per_param enters the loss only in that phase (`train/step.py`), and
the level scales are searched only after it begins. So every λ point
shares steps 1..context_from with the first run, bit for bit, and the
checkpoint that run wrote at `context_from` (`chkpnt10000.pt` at the
reference schedule) is a valid start for each of them. Resume restores
the parameters, buffers, Adam moments, the camera order, the numpy and
torch generator states (`train/loop.py`), so a branched point repeats a
continuous run at its λ and costs only the context steps (20k of 30k).

For each λ the queue trains `<out>/l{λ:g}/` with
`python -m contextgs_tpu_torch.drivers.train ... --start_checkpoint
<base>` (estimate, encode, decode, render the test views from the decoded
scene, results.json), a process of its own started from the repository's
root, its output appended to `<out>/rd_queue.log`, and then appends an
entry to `<out>/summary.jsonl`: `lmbda`, `iters`, `rc` (the run's exit
code, 124 where it ran past its time), `branched_from` (the base's path
relative to `--out`, without its suffix), `last_progress` (the run's
progress.json) and `results` (its results.json), where they exist. These
are the keys of the shell script's entry but its `round`, the label of
the TPU round that wrote it. The layout is the one `scripts.r3_suite`
writes and `scripts.rd_table` reads; the two append to the same file.

A point is skipped when fewer than 900 s are left before `--deadline_ts`
(epoch seconds; default six hours from now); otherwise its run gets the
time left, at most 3 hours. Before its first point the queue waits while
another training run of the port holds the card: a
`contextgs_tpu_torch.drivers.train` process with `--lmbda` and without
`--force_cpu` (`pgrep -af`), polled every 60 s; `--no_wait` skips the
wait. The base may be either package's checkpoint (`chkpnt{it}.pt`, or
the JAX package's `chkpnt{it}.pkl`); a JAX checkpoint carries no torch
generator state, so its noise draws start from the seed.

The shell scripts pass `--train_vis_cap 524288`; the port's train driver
refuses it (it renders every visible gaussian, there is no cap), so the
queue does not pass it and refuses it too. `--force_cpu` goes to every
run; without it the queue runs on the CUDA card or raises before it
starts anything.

    python -m contextgs_tpu_torch.scripts.rd_queue [--out outputs/r4_bench]
        [--base <out>/l0.004/chkpnt10000.pt] [--lmbdas 0.001,0.002]
        [--iters 30000] [--deadline_ts <epoch s>] [--no_wait]
        [--extra_flags '...'] [--force_cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from contextgs_tpu_torch import drivers
from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.scripts import run_logged

TRAINER = ["-m", "contextgs_tpu_torch.drivers.train"]
HOLDER = "contextgs_tpu_torch.drivers.train"
SKIP_UNDER = 900          # seconds left under which a point is skipped
POINT_TIMEOUT = 10_800    # the most seconds a point's run may take
QUEUE_SECONDS = 21_600    # the default deadline, from now
POLL_S = 60
NO_VIS_CAP = ("refused: the port's train driver renders every visible "
              "gaussian of a view and has no visible cap, so the queue does "
              "not pass the shell scripts' --train_vis_cap 524288")


def card_holders() -> list:
    """The command lines of the port's training runs that hold the card:
    `pgrep -af contextgs_tpu_torch.drivers.train` lines with `--lmbda` and
    without `--force_cpu` (a CPU run does not touch the card)."""
    out = subprocess.run(["pgrep", "-af", HOLDER], capture_output=True,
                         text=True).stdout
    return [ln for ln in out.splitlines()
            if "--lmbda" in ln and "--force_cpu" not in ln]


def wait_for_card() -> None:
    """Return once no other training run of the port holds the card."""
    while card_holders():
        time.sleep(POLL_S)


def branched_from(base: str, out: str) -> str:
    """The base checkpoint relative to the output directory, without its
    suffix: "l0.004/chkpnt10000"."""
    return os.path.splitext(os.path.relpath(base, out))[0]


def train_argv(args, lm: float) -> list:
    """The train driver's flags for the point λ = lm, in the order of the
    shell scripts' `python train.py` line."""
    return (["-s", args.scene, "-m", os.path.join(args.out, f"l{lm:g}"),
             "--iterations", str(args.iters), "--lmbda", f"{lm:g}",
             "--voxel_size", f"{args.voxel_size:g}", "--no_tensorboard",
             "--anchor_capacity", str(args.anchor_capacity),
             "--checkpoint_iterations",
             *map(str, args.checkpoint_iterations),
             "--start_checkpoint", args.base]
            + args.extra_flags.split()
            + (["--force_cpu"] if args.force_cpu else []))


def summary_entry(args, lm: float, rc: int) -> dict:
    """The point's summary entry (the keys of the shell script's heredoc
    but `round`)."""
    run = os.path.join(args.out, f"l{lm:g}")
    entry = dict(lmbda=lm, iters=args.iters, rc=rc,
                 branched_from=branched_from(args.base, args.out))
    for name, key in (("progress.json", "last_progress"),
                      ("results.json", "results")):
        path = os.path.join(run, name)
        if os.path.exists(path):
            with open(path) as f:
                entry[key] = json.load(f)
    return entry


def note(log_path: str, text: str) -> None:
    print(text, flush=True)
    with open(log_path, "a") as f:
        f.write(text + "\n")


def run_point(args, lm: float, log_path: str) -> int | None:
    """Train λ = lm from the base within the deadline and append its
    summary entry; → the run's exit code, or None where the deadline
    skipped it."""
    left = args.deadline_ts - time.time()
    if left < SKIP_UNDER:
        note(log_path, f"deadline reached; skipping l{lm:g}")
        return None
    timeout = min(left, POINT_TIMEOUT)
    note(log_path, f"=== l{lm:g} start {time.ctime()} timeout "
                   f"{int(timeout)}s ===")
    rc = run_logged([sys.executable, *TRAINER, *train_argv(args, lm)],
                    log_path, timeout)
    with open(os.path.join(args.out, "summary.jsonl"), "a") as f:
        f.write(json.dumps(summary_entry(args, lm, rc)) + "\n")
    print(f"summary appended for {lm:g} rc {rc}", flush=True)
    return rc


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join("outputs", "r4_bench"))
    p.add_argument("--scene", default=None,
                   help="the scene directory (default <out>/scene)")
    p.add_argument("--base", default=None,
                   help="the checkpoint at the context transition that "
                        "every point starts from (default "
                        "<out>/l0.004/chkpnt10000.pt)")
    p.add_argument("--lmbdas", default="0.001,0.002")
    p.add_argument("--iters", type=int, default=30_000)
    p.add_argument("--voxel_size", type=float, default=0.01)
    p.add_argument("--anchor_capacity", type=int, default=163_840)
    p.add_argument("--checkpoint_iterations", nargs="+", type=int,
                   default=[15_000, 20_000, 25_000])
    p.add_argument("--deadline_ts", type=float, default=None,
                   help="epoch seconds after which no point starts "
                        "(default: six hours from now)")
    p.add_argument("--no_wait", action="store_true",
                   help="start at once, without waiting for other training "
                        "runs of the port to release the card")
    p.add_argument("--extra_flags", default="",
                   help="extra drivers.train flags, space-separated")
    p.add_argument("--train_vis_cap", action=drivers.Refused,
                   help=NO_VIS_CAP)
    p.add_argument("--force_cpu", action="store_true",
                   help="train on the CPU; without it every point runs on "
                        "the CUDA card, and the queue raises where there is "
                        "none")
    return p


def parse(argv=None):
    """The flags, with the output directory, the scene and the base as
    absolute paths and the deadline set."""
    args = build_parser().parse_args(argv)
    args.out = os.path.abspath(args.out)
    args.scene = os.path.abspath(args.scene
                                 or os.path.join(args.out, "scene"))
    args.base = os.path.abspath(args.base or os.path.join(
        args.out, "l0.004", "chkpnt10000.pt"))
    if args.deadline_ts is None:
        args.deadline_ts = time.time() + QUEUE_SECONDS
    return args


def main(argv=None) -> int:
    """Run the queue; → 0 where every point that ran exited 0 (a point the
    deadline skipped is no failure), else 1."""
    args = parse(argv)
    resolve_device("cpu" if args.force_cpu else None)
    if not os.path.exists(args.base):
        print(f"no base checkpoint {args.base}", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    log_path = os.path.join(args.out, "rd_queue.log")

    if not args.no_wait:
        wait_for_card()
    rcs = [run_point(args, float(x), log_path)
           for x in args.lmbdas.split(",")]
    note(log_path, f"=== queue done {time.ctime()} ===")
    return 0 if all(rc in (0, None) for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
