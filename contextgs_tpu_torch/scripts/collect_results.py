"""Aggregate per-run results.json files into a CSV (port of the root
`scripts/collect_results.py`): reads the structured results.json the
drivers write (`drivers.train`, `drivers.test`, `drivers.decompress`) under
a directory, one row a variant of a run.

    python -m contextgs_tpu_torch.scripts.collect_results --root <outputs> \\
        [--out results.csv]
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True, help="outputs directory to scan")
    p.add_argument("--out", default="results.csv")
    args = p.parse_args(argv)

    rows = []
    for path in sorted(glob.glob(os.path.join(args.root, "**", "results.json"),
                                 recursive=True)):
        with open(path) as f:
            data = json.load(f)
        run = os.path.relpath(os.path.dirname(path), args.root)
        for name, m in data.items():
            rows.append(dict(run=run, variant=name,
                             PSNR=m.get("PSNR"), SSIM=m.get("SSIM"),
                             LPIPS=m.get("LPIPS"), FPS=m.get("FPS"),
                             size_MB=m.get("size_MB")))
    if not rows:
        print("no results.json found under", args.root)
        return 1
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {len(rows)} rows to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
