"""Tile-instance expansion and depth sort with dynamic shapes (port of
`contextgs_tpu/ops/rasterize/sorting.py::expand_and_sort`).

The CUDA reference duplicates each gaussian into one instance per touched
tile, sorts by (tile | depth) and finds per-tile ranges. Here:

1. one stable sort of the G gaussians by view depth (culled ones get key
   `inf` and carry no tiles);
2. expansion of the depth-ordered gaussians into their row-major rect tiles
   with `repeat_interleave` over the exclusive cumsum of tile counts;
3. a second *stable* sort by tile id, which keeps depth order within each
   tile, ties broken by gaussian index — the CUDA order.

The reference's static budget, segment padding to the Pallas chunk and
bit-packed fills exist only for XLA's static shapes and are not carried over.
Reading the instance count back to the host is the one synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from contextgs_tpu_torch.ops.rasterize.projection import ProjectedGaussians


class TileInstances(NamedTuple):
    gauss_ids: torch.Tensor    # [B] int32 gaussian index, (tile, depth) order
    tile_bounds: torch.Tensor  # [n_tiles+1] int32 segment boundaries in gauss_ids
    demand: int                # B, the number of tile instances
    n_vis: torch.Tensor        # [] int64 gaussians touching >= 1 tile


def expand_and_sort(proj: ProjectedGaussians, tiles_x: int,
                    tiles_y: int) -> TileInstances:
    """Build the (tile, depth)-sorted tile-instance list."""
    dev = proj.depths.device
    n_tiles = tiles_x * tiles_y
    counts_g = proj.n_tiles.to(torch.int64)
    dkey = torch.where(counts_g > 0, proj.depths, float("inf"))
    order = torch.sort(dkey, stable=True).indices              # depth rank → g
    counts = counts_g[order]
    incl = torch.cumsum(counts, 0)
    demand = int(incl[-1]) if incl.numel() else 0
    offsets = incl - counts                                    # exclusive

    rank = torch.repeat_interleave(
        torch.arange(order.numel(), device=dev), counts,
        output_size=demand)                                    # [B] depth rank
    g = order[rank]
    k = torch.arange(demand, device=dev) - offsets[rank]       # cell in rect
    rmin = proj.rect_min.to(torch.int64)[g]
    rect_w = (proj.rect_max[:, 0].to(torch.int64)
              - proj.rect_min[:, 0].to(torch.int64))[g]
    ty = torch.div(k, rect_w, rounding_mode="floor")
    tile = (rmin[:, 1] + ty) * tiles_x + rmin[:, 0] + (k - ty * rect_w)

    tile_sorted, perm = torch.sort(tile, stable=True)
    gauss_ids = g[perm].to(torch.int32)
    seg_len = torch.bincount(tile_sorted, minlength=n_tiles)
    tile_bounds = torch.zeros(n_tiles + 1, dtype=torch.int32, device=dev)
    tile_bounds[1:] = torch.cumsum(seg_len, 0)
    return TileInstances(gauss_ids=gauss_ids, tile_bounds=tile_bounds,
                         demand=demand, n_vis=(counts_g > 0).sum())
