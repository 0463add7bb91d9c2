"""λ-sweep launcher (port of the root `scripts/sweep.py`): loops (scene, λ)
pairs, each a run of the port's train driver in a process of its own.

Per-dataset presets apply through `--preset`; the default λ are the two
rate-distortion points of the reference's published tables (λ=0.004 low
rate, λ=0.0005 high rate). Everything after `--extra` goes to every run
(for example `--force_cpu`, or a cut schedule). A run that exits non-zero
is reported with `FAILED:` and the sweep goes on.

    python -m contextgs_tpu_torch.scripts.sweep --dataset mipnerf360 \\
        --data_root <dir> --scenes bicycle garden --lmbdas 0.004 0.0005 \\
        --out outputs/360 [--extra --force_cpu]

Each run writes `<out>/<dataset>/<scene>/lmbda_<λ>/`.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

PRESETS = {
    "mipnerf360": dict(preset="mipnerf360"),
    "tandt": dict(preset="tandt"),
    "deep_blending": dict(preset="deep_blending"),
    "nerf_synthetic": dict(preset="nerf_synthetic"),
    "bungeenerf": dict(preset="bungeenerf"),
}
DRIVER = ["-m", "contextgs_tpu_torch.drivers.train"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", required=True, choices=sorted(PRESETS))
    p.add_argument("--data_root", required=True)
    p.add_argument("--scenes", nargs="+", required=True)
    p.add_argument("--lmbdas", nargs="+", type=float,
                   default=[0.004, 0.0005])
    p.add_argument("--out", default="outputs")
    p.add_argument("--iterations", type=int, default=30_000)
    p.add_argument("--extra", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)

    for scene in args.scenes:
        for lm in args.lmbdas:
            model_path = os.path.join(args.out, args.dataset, scene,
                                      f"lmbda_{lm}")
            cmd = [sys.executable, *DRIVER,
                   "-s", os.path.join(args.data_root, scene),
                   "-m", model_path,
                   "--preset", PRESETS[args.dataset]["preset"],
                   "--lmbda", str(lm),
                   "--iterations", str(args.iterations)] + args.extra
            print("+", " ".join(cmd), flush=True)
            ret = subprocess.run(cmd).returncode
            if ret != 0:
                print(f"FAILED: {scene} λ={lm} (exit {ret})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
