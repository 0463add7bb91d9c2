"""Rasterizer throughput over (gaussian count, resolution) (port of the root
`scripts/thr_sweep.py`): forward+backward Mpix/s from the bench's 200k
gaussians at 1280x720 up to 2M at 1280x720 and 1M at 1920x1080, the sizes
of the reference's scenes.

Each row draws the JAX script's gaussians (`scripts/thr_sweep.py:53-64`):
bench.py's recipe with the scales U(0.2·s_hi, s_hi), s_hi =
0.02·sqrt(200k / G), so that the instances a pixel holds stay near the
bench's as G grows. At 200k, s_hi is 0.02 and 0.2·0.02 is 0.004 in float64,
so that row draws the bench's frame (547,648 instances). A row is `iters`
chained forward+backward steps, `drivers.bench.step`, after
`drivers.bench.WARMUP` untimed ones, timed by CUDA events around the chain
(`drivers.bench.chain_seconds`). K1 and K2 each run `WARMUP + iters` times
a row.

Each row prints its tile-instance demand where the JAX script prints its
budget and `OVERFLOW` column: the port's tile lists are sized per render,
so no budget is set and nothing can overflow. The demand is the sum of the
opacity-aware tile rects of `project_gaussians` (`probe_demand`). Beside it
the card's peak memory over the row (not measured on the CPU).

    python -m contextgs_tpu_torch.scripts.thr_sweep [--iters 20]
        [--configs 200000x1280x720,1000000x1280x720,...] [--force_cpu]

`--budget_per_mpix` is refused for that reason.
"""

from __future__ import annotations

import argparse
import math
import sys

import torch

from contextgs_tpu_torch.config import NO_BUDGET
from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.drivers import Refused, bench
from contextgs_tpu_torch.ops.rasterize import TILE, project_gaussians

DEFAULT = ("200000x1280x720,1000000x1280x720,2000000x1280x720,"
           "200000x1920x1080,1000000x1920x1080")


def configs(spec: str) -> list:
    """"GxWxH,..." → [(G, W, H), ...]."""
    return [tuple(int(x) for x in row.split("x")) for row in spec.split(",")]


def inputs(n_gauss: int, device) -> tuple:
    """The JAX script's seeded gaussians for G = n_gauss: means, scales,
    quats, colors, opacities."""
    s_hi = 0.02 * math.sqrt(200_000 / n_gauss)
    return bench.inputs(n_gauss, device, 0.2 * s_hi, s_hi)


def probe_demand(means, scales, quats, opac, cam_kw: dict) -> int:
    """Tile instances of this frame: the opacity-aware rects'
    tiles summed over the gaussians."""
    with torch.no_grad():
        proj = project_gaussians(
            means, scales, quats, cam_kw["world_view"], cam_kw["full_proj"],
            cam_kw["tanfovx"], cam_kw["tanfovy"], cam_kw["width"],
            cam_kw["height"], TILE, opacities=opac)
    return int(proj.n_tiles.sum())


def measure(n_gauss: int, width: int, height: int, iters: int,
            device=None) -> dict:
    """One row: ms an iteration, Mpix/s, the demand, and the card's peak
    memory in GiB over the row (None on the CPU)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    means, *rest = inputs(n_gauss, dev)
    cam_kw = bench.camera_kwargs(width, height, dev)
    demand = probe_demand(means, rest[0], rest[1], rest[3], cam_kw)
    rest = [x.requires_grad_(True) for x in rest]
    seconds = bench.chain_seconds(means, rest, cam_kw, iters, dev)
    return dict(gaussians=n_gauss, width=width, height=height, iters=iters,
                ms_per_iter=seconds / iters * 1e3,
                mpix_s=iters * width * height / seconds / 1e6, demand=demand,
                peak_gib=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                          if on_card else None),
                device=torch.cuda.get_device_name(dev) if on_card else "cpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--configs", default=DEFAULT)
    ap.add_argument("--budget_per_mpix", action=Refused,
                    help="refused: " + NO_BUDGET)
    ap.add_argument("--force_cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions); "
                         "without it the sweep runs on the CUDA card or "
                         "raises")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.force_cpu else None)
    print(f"{'gaussians':>10} {'res':>10} {'ms/iter':>9} {'Mpix/s':>8} "
          f"{'demand':>9} {'peak GiB':>12}")
    for g, w, h in configs(args.configs):
        r = measure(g, w, h, args.iters, dev)
        peak = ("not measured" if r["peak_gib"] is None
                else f"{r['peak_gib']:.2f}")
        print(f"{g:>10} {w:>5}x{h:<4} {r['ms_per_iter']:>9.1f} "
              f"{r['mpix_s']:>8.2f} {r['demand']:>9} {peak:>12} "
              f"({r['device']})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
