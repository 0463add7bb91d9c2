"""Tile instances whose alpha never reaches 1/255 in their tile (port of the
root `scripts/corner_diag.py`).

The blend skips every pixel whose alpha is under 1/255, so an instance
whose largest alpha over its own 16x16 tile is under 1/255 adds nothing:
it sits in a corner of its gaussian's tile rect that the ellipse misses.
K1's and K2's footprint culls drop such instances inside the kernels; a
per-tile test in the binning could drop them before. The frame is 200k
seeded gaussians at 1280x720 drawn as `scripts/corner_diag.py:50-56` draws
them: bench.py's recipe without the colours, so the opacities come from
the draws the bench spends on colours and the frame is not the bench's
(547,655 instances against its 547,648).

The keys are the JAX script's:

- `demand_plain`, `demand_tight`: tile instances of the plain rects
  (`project_gaussians` without opacities) and of the opacity-aware
  ellipse boxes (with them); `bbox_gain` = 1 - tight / plain;
- `n_valid`: the instances `expand_and_sort` lists. The port's lists hold
  no padded slot, so it always equals `demand_tight` (checked);
- `n_wasted`: the listed instances with op·exp(min(best, 0)) < 1/255,
  `best` the largest power over the tile's pixels, taken in 16 passes of
  one pixel row each (`:91-97`) so that no [B, 16, 16] tensor is made;
  `wasted_frac` = n_wasted / n_valid;
- `wall_s`: seconds of the computation, to its last value on the host.

    python -m contextgs_tpu_torch.scripts.corner_diag [--n_gauss 200000]
        [--width 1280] [--height 720] [--force_cpu]

`--budget` is refused: the port's tile lists are sized per render.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from contextgs_tpu_torch.config import NO_BUDGET
from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.drivers import Refused, bench
from contextgs_tpu_torch.ops.rasterize import (TILE, expand_and_sort,
                                               project_gaussians)
from contextgs_tpu_torch.ops.rasterize.common import ALPHA_EPS


def inputs(n_gauss: int, device, scale_lo: float = 0.004,
           scale_hi: float = 0.02) -> tuple:
    """The JAX script's seeded means, scales, quats and opacities: the
    bench's draws with the opacities in the colours' place."""
    rng = np.random.default_rng(0)
    means, scales, quats = bench.geometry(rng, n_gauss, scale_lo, scale_hi)
    opac = rng.uniform(0.2, 0.9, n_gauss).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device)
                 for x in (means, scales, quats, opac))


def max_power(means2d, conics, gauss_ids, tile_bounds, tiles_x: int):
    """[B] the largest power of each listed instance over its tile's
    pixels, one pixel row of the tile a pass."""
    n_tiles = tile_bounds.numel() - 1
    dev = gauss_ids.device
    tile = torch.repeat_interleave(
        torch.arange(n_tiles, device=dev),
        (tile_bounds[1:] - tile_bounds[:-1]).to(torch.int64))
    g = gauss_ids.to(torch.int64)
    m2, con = means2d[g], conics[g]
    k = torch.arange(TILE, device=dev)
    dx = ((tile % tiles_x) * TILE)[:, None].add(k).float() - m2[:, 0:1]
    dy = ((tile // tiles_x) * TILE)[:, None].add(k).float() - m2[:, 1:2]
    best = torch.full((g.numel(),), -torch.inf, device=dev)
    for i in range(TILE):
        dyi = dy[:, i:i + 1]
        powr = (-0.5 * (con[:, 0:1] * dx * dx + con[:, 2:3] * dyi * dyi)
                - con[:, 1:2] * dx * dyi)
        best = torch.maximum(best, powr.amax(1))
    return best


def measure(n_gauss: int = 200_000, width: int = 1280, height: int = 720,
            scale_lo: float = 0.004, scale_hi: float = 0.02,
            device=None) -> dict:
    """The JAX script's dict for this frame."""
    dev = resolve_device(device)
    means, scales, quats, opac = inputs(n_gauss, dev, scale_lo, scale_hi)
    cam = bench.camera_kwargs(width, height, dev)
    geom = (cam["world_view"], cam["full_proj"], cam["tanfovx"],
            cam["tanfovy"], width, height, TILE)
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    t0 = time.perf_counter()
    with torch.no_grad():
        plain = project_gaussians(means, scales, quats, *geom)
        proj = project_gaussians(means, scales, quats, *geom,
                                 opacities=opac)
        inst = expand_and_sort(proj, tiles_x, tiles_y)
        best = max_power(proj.means2d, proj.conics, inst.gauss_ids,
                         inst.tile_bounds, tiles_x)
        alpha_max = (opac[inst.gauss_ids.to(torch.int64)]
                     * torch.exp(torch.clamp(best, max=0.0)))
        out = dict(demand_plain=int(plain.n_tiles.sum()),
                   demand_tight=int(proj.n_tiles.sum()),
                   n_valid=inst.demand,
                   n_wasted=int((alpha_max < ALPHA_EPS).sum()))
    if out["n_valid"] != out["demand_tight"]:
        raise RuntimeError(f"corner_diag: {out['n_valid']} listed instances "
                           f"against a demand of {out['demand_tight']}")
    out["wasted_frac"] = round(out["n_wasted"] / max(out["n_valid"], 1), 4)
    out["bbox_gain"] = round(1 - out["demand_tight"]
                             / max(out["demand_plain"], 1), 4)
    out["wall_s"] = round(time.perf_counter() - t0, 1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_gauss", type=int, default=200_000)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--scale_lo", type=float, default=0.004)
    ap.add_argument("--scale_hi", type=float, default=0.02)
    ap.add_argument("--budget", action=Refused, help="refused: " + NO_BUDGET)
    ap.add_argument("--force_cpu", action="store_true",
                    help="run on the CPU; without it the diagnosis runs on "
                         "the CUDA card or raises")
    args = ap.parse_args(argv)
    print(measure(args.n_gauss, args.width, args.height, args.scale_lo,
                  args.scale_hi, "cpu" if args.force_cpu else None))
    return 0


if __name__ == "__main__":
    sys.exit(main())
