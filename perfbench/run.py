"""Run one cell of the benchmark of `contextgs_tpu_torch` on the CUDA card:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It makes the cell's inputs from the seed,
warms up, measures for `--seconds` (with `--trace 1`, traces the mix's
traced units instead), compares what the timed path produced with the
plain reference, and prints one JSON line last on standard output: the
end-to-end metrics, or with `--trace 1` the per-layer ones and the
breakdown. It exits non-zero and prints no result without enough CUDA
cards, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# the program's kernel caches, at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": REPO / "build" / "triton",
          "TORCH_EXTENSIONS_DIR": REPO / "build" / "torch_extensions"}


def card_line() -> str:
    """The card's name, power limit and SM clock as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, path in CACHES.items():
        os.environ[key] = str(path)
    sys.path.insert(0, str(REPO))

    import torch

    from perfbench import harness

    cell = harness.load_cell(REPO, args.workload, bool(args.trace))
    if not torch.cuda.is_available() or torch.cuda.device_count() < \
            cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    result, checks = harness.run_cell(cell, args.seed, args.seconds,
                                      bool(args.trace),
                                      torch.device("cuda"))
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"loaded in this process: {', '.join(loaded)}", file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    for name, (value, limit) in checks.items():
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
