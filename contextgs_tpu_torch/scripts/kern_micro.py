"""K1's and K2's cost per tile against their cost per instance (port of the
root `scripts/kern_micro.py`).

K1 (`tile_kernel.blend_forward`) and K2 (`tile_kernel.blend_backward`, on
K1's outputs with cotangents of ones, `scripts/kern_micro.py:98-100`) are
timed by `scripts.time_ms` on one instance table while only its tile
bounds move: the same chunks of 128 instances spread over many tiles or
packed into a few, at the six `(chunks a tile, active tiles)` of
`:83-91` on the 80x45 tiles of a 1280x720 view. The JAX script's fit is
time = a·active tiles + b·chunks.

The table is the one the JAX script and the kvariants lab build with the
same draws (`scripts/kern_micro.py:47-53`, `kvariants.lab_inputs`): rows
[budget + tiles·128, 9], mean x U(0, 1280), mean y U(0, 720), conic (0.1,
0, 0.1), opacity U(0.2, 0.9), rgb U(0, 1), gauss_ids = arange.

What the table times: its instances lie anywhere in the image, so almost
none meets the tile that lists it (of the 1x3600 table's 118M (pixel,
instance) pairs, 39,223 reach 1/255). K1's and K2's footprint
culls drop the rest before any power or exp, so these rows time per-tile
setup, the row gather and the footprint pass, not the blend; the rendered
views of `profile` and `thr_sweep` time the blend. Each row prints the
(pixel, instance) pairs that reach alpha ≥ 1/255 beside its times, so the
reader sees this.

    python -m contextgs_tpu_torch.scripts.kern_micro [--iters 20]
        [--tiles 80x45] [--force_cpu]

`--budget` and `--chunk` are refused: the table keeps the JAX script's
sizes (budget 768k, chunks of 128), and the port's kernels take each
tile's list whole with no budget to set.
"""

from __future__ import annotations

import argparse
import sys

import torch

from contextgs_tpu_torch.config import NO_BUDGET, NO_CHUNK
from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.drivers import Refused
from contextgs_tpu_torch.ops.rasterize import tile_kernel
from contextgs_tpu_torch.ops.rasterize.common import (alpha_from_power,
                                                      gaussian_power)
from contextgs_tpu_torch.scripts import ITERS, kvariants, time_ms

TILE = tile_kernel.TILE
# (chunks of 128 instances a tile, 1 / the share of the tiles active): on
# the 80x45 tiles of a 1280x720 view the JAX script's 1x3600, 2x1800,
# 8x450, 32x112, 2x3600 and 16x450
CONFIGS = ((1, 1), (2, 2), (8, 8), (32, 32), (2, 1), (16, 8))


def reaching_pairs(rows, gauss_ids, tile_bounds, tiles_x: int) -> int:
    """(pixel, instance) pairs of the listed instances whose alpha over
    their own tile reaches 1/255, K1's skip rules, no transmittance."""
    pos, tile_of = kvariants._list_positions(tile_bounds,
                                             tile_bounds.numel() - 1)
    pix = torch.arange(TILE * TILE, device=rows.device)
    n = 0
    for k in range(0, pos.numel(), kvariants.PAIRS_STEP):
        t = tile_of[k:k + kvariants.PAIRS_STEP]
        r = rows[gauss_ids[pos[k:k + kvariants.PAIRS_STEP]].to(torch.int64)]
        px = ((t % tiles_x) * TILE)[:, None] + pix % TILE
        py = ((t // tiles_x) * TILE)[:, None] + pix // TILE
        power = gaussian_power(r[:, 0, None] - px.to(rows.dtype),
                               r[:, 1, None] - py.to(rows.dtype),
                               r[:, 2, None], r[:, 3, None], r[:, 4, None])
        n += int((alpha_from_power(power, r[:, 5, None]) > 0).sum())
    return n


def measure(device=None, iters: int = ITERS, configs=CONFIGS, *,
            tiles_x: int = kvariants.TILES_X,
            tiles_y: int = kvariants.TILES_Y, budget: int | None = None,
            keep_kernel_args: bool = False) -> list:
    """One dict a config: label, chunks a tile, active tiles, listed
    instances, pairs reaching 1/255, fwd and bwd ms a call. The table
    holds `budget` + tiles·128 rows; by default the lab's budget scaled to
    the view's tiles (768k at 80x45). K1 and K2 run `iters + 1` times a
    config by `time_ms`, K1 once more for K2's inputs. With
    `keep_kernel_args`, each dict also holds the config's K1 and K2
    arguments (`kernel_args`), so that a caller can hold the kernels
    against their plain versions on these inputs."""
    dev = resolve_device(device)
    width, height = TILE * tiles_x, TILE * tiles_y
    n_tiles = tiles_x * tiles_y
    if budget is None:
        budget = kvariants.BUDGET * n_tiles // (kvariants.TILES_X
                                                * kvariants.TILES_Y)
    out = []
    for cpt, every in configs:
        active = n_tiles // every
        label = f"{cpt} chunk x {active:4d} tiles ({cpt * active}ch)"
        rows, ids, bounds = kvariants.lab_inputs(
            cpt, active, tiles_x=tiles_x, tiles_y=tiles_y, budget=budget,
            device=dev)
        lists = (rows, ids, bounds)
        fwd = tile_kernel.blend_forward(*lists, width, height)
        ones = (torch.ones_like(fwd[0]), torch.ones_like(fwd[1]))
        row = dict(
            label=label, chunks_per_tile=cpt, active_tiles=active,
            instances=int(bounds[-1]),
            reaching_pairs=reaching_pairs(rows, ids, bounds, tiles_x),
            fwd_ms=time_ms(lambda: tile_kernel.blend_forward(
                *lists, width, height), dev, iters),
            bwd_ms=time_ms(lambda: tile_kernel.blend_backward(
                *lists, *fwd, *ones, width, height), dev, iters))
        if keep_kernel_args:
            row["kernel_args"] = dict(
                blend_forward=(*lists, width, height),
                blend_backward=(*lists, *fwd, *ones, width, height))
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--tiles", default=f"{kvariants.TILES_X}x"
                    f"{kvariants.TILES_Y}",
                    help="the view's tiles, XxY (80x45: 1280x720); a cut "
                         "view keeps each config's share of active tiles")
    ap.add_argument("--budget", action=Refused, help="refused: " + NO_BUDGET)
    ap.add_argument("--chunk", action=Refused, help="refused: " + NO_CHUNK)
    ap.add_argument("--force_cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions); "
                         "without it the table runs on the CUDA card or "
                         "raises")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.force_cpu else None)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"kern_micro on {where}: ms a call, mean of {args.iters} calls")
    tiles_x, tiles_y = (int(x) for x in args.tiles.split("x"))
    for r in measure(dev, args.iters, tiles_x=tiles_x, tiles_y=tiles_y):
        print(f"{r['label']}: fwd {r['fwd_ms']:7.3f} ms   bwd "
              f"{r['bwd_ms']:7.3f} ms   pairs reaching 1/255: "
              f"{r['reaching_pairs']} of {r['instances'] * TILE * TILE}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
