"""Tile-instance expansion and depth sort with dynamic shapes (port of
`contextgs_tpu/ops/rasterize/sorting.py::expand_and_sort`).

The CUDA reference duplicates each gaussian into one instance per touched
tile, sorts by (tile | depth) and finds per-tile ranges. Here:

1. one stable sort of the G gaussians by view depth (culled ones get key
   `inf` and carry no tiles);
2. expansion of the depth-ordered gaussians into their row-major rect tiles
   at the exclusive prefix sum of their tile counts;
3. a second *stable* sort by tile id, which keeps depth order within each
   tile, ties broken by gaussian index — the CUDA order;
4. each tile's range in the sorted list.

`expand_and_sort` follows the tensors: on CUDA tensors it launches the
hand-written passes of `csrc/binning.cu` (int32 throughout, the tile sort
over the `tile_sort_bits(n_tiles)` low bits only, the ranges written by one
kernel), two C calls a call, counted in `launches`; on CPU tensors it runs
the plain op chain, `expand_and_sort_plain`. Neither falls back to the
other, and their outputs are equal. Reading the instance count back to the
host is the card path's one synchronisation (the chain's bincount adds two).
Every call adds its instances to the trace counter `tile_instances`, and a
card call to `bin_card_instances` too.

The reference's static budget, segment padding to the Pallas chunk and
bit-packed fills exist only for XLA's static shapes and are not carried over.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from contextgs_tpu_torch.ops.cuda_build import c_function, launch
from contextgs_tpu_torch.ops.rasterize.projection import ProjectedGaussians
from contextgs_tpu_torch.utils import trace

SOURCE = Path(__file__).resolve().parent / "csrc" / "binning.cu"
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
DEPTH_ARGTYPES = [_P, _L, _P, _L, _I] + [_P] * 4
TILE_ARGTYPES = ([_P, _I, _P, _L, _P, _L] + [_I] * 5 + [_P] * 5)
INT32_MAX = 2 ** 31 - 1

launches = 0


class TileInstances(NamedTuple):
    gauss_ids: torch.Tensor    # [B] int32 gaussian index, (tile, depth) order
    tile_bounds: torch.Tensor  # [n_tiles+1] int32 segment boundaries in gauss_ids
    demand: int                # B, the number of tile instances
    n_vis: torch.Tensor        # [] int64 gaussians touching >= 1 tile


def expand_and_sort_plain(proj: ProjectedGaussians, tiles_x: int,
                          tiles_y: int,
                          tile_row_offset: int = 0) -> TileInstances:
    """The plain op chain of `expand_and_sort`: the kernels' plain version,
    which CPU tensors take."""
    dev = proj.depths.device
    n_tiles = tiles_x * tiles_y
    counts_g = proj.n_tiles.to(torch.int64)
    dkey = torch.where(counts_g > 0, proj.depths, float("inf"))
    order = torch.sort(dkey, stable=True).indices              # depth rank → g
    counts = counts_g[order]
    incl = torch.cumsum(counts, 0)
    with trace.sync("sort.demand"):
        demand = int(incl[-1]) if incl.numel() else 0
    trace.count("tile_instances", demand)
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
    tile = ((rmin[:, 1] - tile_row_offset + ty) * tiles_x + rmin[:, 0]
            + (k - ty * rect_w))

    tile_sorted, perm = torch.sort(tile, stable=True)
    gauss_ids = g[perm].to(torch.int32)
    # CUDA's bincount reads the input's least and greatest value back
    with trace.sync("sort.bins", 2):
        seg_len = torch.bincount(tile_sorted, minlength=n_tiles)
    tile_bounds = torch.zeros(n_tiles + 1, dtype=torch.int32, device=dev)
    tile_bounds[1:] = torch.cumsum(seg_len, 0)
    return TileInstances(gauss_ids=gauss_ids, tile_bounds=tile_bounds,
                         demand=demand, n_vis=(counts_g > 0).sum())


def tile_sort_bits(n_tiles: int) -> int:
    """The low bits of a local tile id in [0, n_tiles) that the tile sort
    orders: ceil(log2(n_tiles)), at least 1."""
    return max(1, (n_tiles - 1).bit_length())


def _vector(name, x, dtype, n, device):
    """(pointer, stride) of a [n] tensor of `dtype` on `device`."""
    if (x.device != device or x.dtype != dtype or x.dim() != 1
            or x.shape[0] != n):
        raise ValueError(f"expand_and_sort: {name} must be a {dtype} [{n}] "
                         f"tensor on {device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    return x.data_ptr(), x.stride(0)


def _rect(name, x, n, device):
    """(pointer, row stride) of an int32 [n, 2] tensor on `device` whose two
    columns lie contiguous."""
    if (x.device != device or x.dtype != torch.int32 or x.dim() != 2
            or tuple(x.shape) != (n, 2) or x.stride(1) != 1):
        raise ValueError(f"expand_and_sort: {name} must be an int32 [{n},2] "
                         f"tensor on {device} with contiguous columns, got "
                         f"{x.dtype} {tuple(x.shape)} strides {x.stride()} "
                         f"on {x.device}")
    return x.data_ptr(), x.stride(0)


def _launch(fn, device, args):
    err = launch(fn, device, *args)
    if err != 0:
        raise RuntimeError(f"expand_and_sort: kernel launch failed with CUDA "
                           f"error {err}")


def _workspace(fn, device, head, tail):
    """The workspace `fn` takes for the arguments `head`, sized by `fn`
    itself (called with a `need` pointer it launches nothing)."""
    need = ctypes.c_longlong(-1)
    _launch(fn, device, (*head, None, ctypes.addressof(need), *tail))
    return torch.empty(need.value, dtype=torch.uint8, device=device)


def _expand_and_sort_card(proj, tiles_x, tiles_y, tile_row_offset):
    """The two passes of csrc/binning.cu: the depth pass (its workspace
    keeps the depth order, the counts and their prefix sum), the demand
    read back, the tile pass."""
    global launches
    dev = proj.depths.device
    n = proj.depths.shape[0]
    if n > INT32_MAX:
        raise ValueError(f"expand_and_sort: {n} gaussians, more than int32 "
                         f"ids address")
    n_tiles = tiles_x * tiles_y
    head = (*_vector("depths", proj.depths, torch.float32, n, dev),
            *_vector("n_tiles", proj.n_tiles, torch.int32, n, dev), n)
    rects = (*_rect("rect_min", proj.rect_min, n, dev),
             *_rect("rect_max", proj.rect_max, n, dev))
    depth_pass = c_function(SOURCE, "bin_depth_pass", DEPTH_ARGTYPES)
    work = _workspace(depth_pass, dev, head, (None,))
    stats = torch.empty(2, dtype=torch.int64, device=dev)   # n_vis, demand
    _launch(depth_pass, dev, (*head, work.data_ptr(), None,
                              stats.data_ptr()))
    launches += 1
    with trace.sync("sort.demand"):
        demand = int(stats[1])
    if demand > INT32_MAX:
        raise ValueError(f"expand_and_sort: {demand} tile instances, more "
                         f"than int32 lists address")
    trace.count("tile_instances", demand)
    trace.count("bin_card_instances", demand)
    tile_pass = c_function(SOURCE, "bin_tile_pass", TILE_ARGTYPES)
    head = (work.data_ptr(), n, *rects, tiles_x, tile_row_offset, n_tiles,
            tile_sort_bits(n_tiles), demand)
    tile_work = _workspace(tile_pass, dev, head, (None, None))
    gauss_ids = torch.empty(demand, dtype=torch.int32, device=dev)
    tile_bounds = torch.empty(n_tiles + 1, dtype=torch.int32, device=dev)
    _launch(tile_pass, dev, (*head, tile_work.data_ptr(), None,
                             gauss_ids.data_ptr(), tile_bounds.data_ptr()))
    launches += 1
    return TileInstances(gauss_ids=gauss_ids, tile_bounds=tile_bounds,
                         demand=demand, n_vis=stats[0])


def expand_and_sort(proj: ProjectedGaussians, tiles_x: int, tiles_y: int,
                    tile_row_offset: int = 0) -> TileInstances:
    """Build the (tile, depth)-sorted tile-instance list. With
    `tile_row_offset`, tile ids are local to a horizontal band of `tiles_y`
    tile rows starting at that row (the rects must already be clamped to
    the band by the projection)."""
    dev = proj.depths.device
    if dev.type == "cpu":
        return expand_and_sort_plain(proj, tiles_x, tiles_y, tile_row_offset)
    if dev.type != "cuda":
        raise ValueError(f"expand_and_sort: unsupported device {dev}")
    return _expand_and_sort_card(proj, tiles_x, tiles_y, tile_row_offset)
