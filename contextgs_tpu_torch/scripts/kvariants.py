"""K4, the tile-blend forward in five cumulative stages (port of
`scripts/kvariants.py`, replacing its Pallas lab kernel `make_kernel` run by
`run_variant`).

The lab times the forward built up stage by stage to see where its time
goes. Here each level is a stage of K1's design (`csrc/kvariants.cu`; K1 is
`ops/rasterize/csrc/blend_forward.cu`: 8x4-pixel warps walking per-warp
lists compacted from each instance's alpha footprint), with K1's inputs and
outputs:

    v0_empty          reads the tile's bounds; rgb 0, T 1, last_contrib 0
    v1_gather         + the batch loop and the row gather into the records
    v2_power          + footprint, warp masks, per-warp lists, and power,
                      exp and alpha on the listed pairs (no early exit)
    v3_transmittance  + T, the t_eps test, the early exit and last_contrib
    v4_full           + the colour: K1's function by K1's walk

Levels 1-3 write a sink in place of the colour, the lab's (`:72-89`):
rgb[c] = 1e-30 Σ row[c] over the first instance of every 128-instance chunk
(v1; mean x, mean y, conic a), 1e-30 Σ alpha (v2), 1e-30 Σ alpha·T (v3).
Level 3's T and last_contrib are K1's. The cull drops only pairs whose
alpha is under 1/255, which every level skips, so the plain versions
below hold for the culled walk bit for bit. Level 4 differs from K1 only in
its staging: the row gather of the next batch lands by `cp.async` in a
second buffer while the warps walk this one, so v4 against K1 is what
asynchronous staging is worth to K1.

Unlike the lab, the stages carry T across chunks, as K1 does: the lab's v3
restarts T at 1 in every chunk, and its v4 can blend a pixel again at a
chunk boundary after the pixel was done.

`blend_variant` checks its inputs as K1's wrapper does; on a CUDA tensor it
launches K4 at that level or raises, on a CPU tensor it runs the plain
version `blend_variant_reference`. `launches[level]` counts the launches of
each level in this process. `run_all` and `main` run the lab's table: v0-v4
on the lab's instance table at 1x3600, 2x3600 and 8x450 (chunks of 128 per
active tile x active tiles of the 80x45 tiles of a 1280x720 view). The
table's instances lie anywhere in the image, so almost none meets its
tile: there v2-v4 time the gather and the footprint pass, and the inputs
of a rendered view are what split K1's time.

    python -m contextgs_tpu_torch.scripts.kvariants
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.ops.cuda_build import c_function, launch
from contextgs_tpu_torch.ops.rasterize.common import (T_EPS, alpha_from_power,
                                                      gaussian_power)
from contextgs_tpu_torch.ops.rasterize.reference import (_untile,
                                                         blend_tiles_reference)
from contextgs_tpu_torch.ops.rasterize.tile_kernel import (TILE, _check_lists,
                                                           _grid)
from contextgs_tpu_torch.scripts import ITERS, time_ms

SOURCE = Path(__file__).resolve().parent / "csrc" / "kvariants.cu"
LEVELS = ("v0_empty", "v1_gather", "v2_power", "v3_transmittance", "v4_full")
CHUNK = 128                 # the lab's C: v1's sink reads one row a chunk
SINK = 1e-30                # the lab's sink scale
TILES_X, TILES_Y = 80, 45   # a 1280x720 view
BUDGET = 768 * 1024         # the lab's table holds BUDGET + tiles·CHUNK rows
# the lab's configurations as (chunks in each active tile, 1 / the share of
# tiles active): 1x3600, 2x3600 and 8x450 on the 80x45 tiles
CONFIGS = ((1, 1), (2, 1), (8, 8))
PAIRS_STEP = 1 << 16        # instances a step of the plain v2 takes

# blend_variant's C arguments: level, rows, ids, bounds, width, height,
# tiles_x, n_tiles, t_eps, rgb, final_t, last_contrib (the stream is added
# by `launch`)
ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
            + [ctypes.c_float] + [ctypes.c_void_p] * 4)

launches = [0] * len(LEVELS)


def lab_inputs(cpt, active: int, seed: int = 0, *, tiles_x: int = TILES_X,
               tiles_y: int = TILES_Y, budget: int = BUDGET, device=None):
    """The lab's instance table (`scripts/kvariants.py:140-158`) in K1's
    form: rows [b_pad, 9] f32 with b_pad = budget + tiles·128, mean x
    U(0, 16·tiles_x), mean y U(0, 16·tiles_y), conic (0.1, 0, 0.1), opacity
    U(0.2, 0.9), rgb U(0, 1), drawn in the lab's order from
    `np.random.default_rng(seed)`; gauss_ids = arange(b_pad) i32; and
    tile_bounds [tiles+1] i32 in which the first `active` tiles hold `cpt`
    chunks of 128 instances (or cpt[i] for tile i, given a sequence) and the
    rest none."""
    dev = resolve_device(device)
    n_tiles = tiles_x * tiles_y
    b_pad = budget + n_tiles * CHUNK
    rng = np.random.default_rng(seed)
    rows = np.zeros((b_pad, 9), np.float32)
    rows[:, 0] = rng.uniform(0, 16 * tiles_x, b_pad)
    rows[:, 1] = rng.uniform(0, 16 * tiles_y, b_pad)
    rows[:, 2] = rows[:, 4] = 0.1
    rows[:, 5] = rng.uniform(0.2, 0.9, b_pad)
    rows[:, 6:9] = rng.uniform(0, 1, (3, b_pad)).T
    per = np.zeros(n_tiles, np.int64)
    per[:active] = np.asarray(cpt) * CHUNK
    bounds = np.concatenate([[0], np.cumsum(per)]).astype(np.int32)
    if bounds[-1] > b_pad:
        raise ValueError(f"lab_inputs: {bounds[-1]} listed instances exceed "
                         f"the table's {b_pad} rows")
    return (torch.from_numpy(rows).to(dev),
            torch.arange(b_pad, dtype=torch.int32, device=dev),
            torch.from_numpy(bounds).to(dev))


def _list_positions(tile_bounds, n_tiles):
    """(list positions [B] i64, the tile of each [B] i64)."""
    bounds = tile_bounds.to(torch.int64)
    pos = torch.arange(int(bounds[0]), int(bounds[-1]),
                       device=tile_bounds.device)
    tile_of = torch.repeat_interleave(
        torch.arange(n_tiles, device=tile_bounds.device),
        bounds[1:] - bounds[:-1])
    return pos, tile_of


def _chunk_sums(rows, gauss_ids, tile_bounds, n_tiles):
    """[n_tiles, 3]: Σ rows[:, 0:3] over the first instance of every
    128-instance chunk of each tile's list (v1's sink, unscaled)."""
    pos, tile_of = _list_positions(tile_bounds, n_tiles)
    first = (pos - tile_bounds.to(torch.int64)[tile_of]) % CHUNK == 0
    sums = torch.zeros((n_tiles, 3), dtype=rows.dtype, device=rows.device)
    return sums.index_add_(0, tile_of[first],
                           rows[gauss_ids[pos[first]].to(torch.int64), :3])


def _alpha_sums(rows, gauss_ids, tile_bounds, tiles_x, n_tiles):
    """[n_tiles, 256]: Σ alpha over each tile's list for each of its pixels,
    with K1's skip rules and no early exit (v2's sink, unscaled)."""
    dev = rows.device
    pix = torch.arange(TILE * TILE, device=dev)
    pos, tile_of = _list_positions(tile_bounds, n_tiles)
    sums = torch.zeros((n_tiles, TILE * TILE), dtype=rows.dtype, device=dev)
    for k in range(0, pos.numel(), PAIRS_STEP):
        t = tile_of[k:k + PAIRS_STEP]
        r = rows[gauss_ids[pos[k:k + PAIRS_STEP]].to(torch.int64)]
        px = ((t % tiles_x) * TILE)[:, None] + pix % TILE
        py = ((t // tiles_x) * TILE)[:, None] + pix // TILE
        power = gaussian_power(r[:, 0, None] - px.to(rows.dtype),
                               r[:, 1, None] - py.to(rows.dtype),
                               r[:, 2, None], r[:, 3, None], r[:, 4, None])
        sums.index_add_(0, t, alpha_from_power(power, r[:, 5, None]))
    return sums


def blend_variant_reference(level: int, rows: torch.Tensor,
                            gauss_ids: torch.Tensor, tile_bounds: torch.Tensor,
                            width: int, height: int, t_eps: float = T_EPS):
    """The plain version of K4 at `level`: (rgb [3,H,W], final_T [H,W],
    last_contrib [H,W] i32), with the sinks of levels 1-3 in rgb. Level 4 is
    `blend_tiles_reference`; level 3's T and last_contrib are its, and its
    sink is the rgb it gives with every colour set to 1."""
    tiles_x, n_tiles = _grid(width, height)
    dev = rows.device
    if level in (3, 4):
        if level == 3:
            rows = rows.clone()
            rows[:, 6:9] = 1.0
        rgb, final_t, last = blend_tiles_reference(
            rows, gauss_ids, tile_bounds, width, height, tiles_x, TILE, t_eps)
        return (SINK * rgb if level == 3 else rgb), final_t, last
    final_t = torch.ones((height, width), dtype=rows.dtype, device=dev)
    last = torch.zeros((height, width), dtype=torch.int32, device=dev)
    if level == 0:
        sink = torch.zeros((3, n_tiles, 1), dtype=rows.dtype, device=dev)
    elif level == 1:
        sink = _chunk_sums(rows, gauss_ids, tile_bounds, n_tiles).T[..., None]
    else:
        sink = _alpha_sums(rows, gauss_ids, tile_bounds, tiles_x,
                           n_tiles)[None]
    rgb = SINK * sink.expand(3, n_tiles, TILE * TILE)
    return _untile(rgb, tiles_x, TILE, width, height), final_t, last


def blend_variant(level: int, rows: torch.Tensor, gauss_ids: torch.Tensor,
                  tile_bounds: torch.Tensor, width: int, height: int,
                  t_eps: float = T_EPS):
    """K4 at `level` (0-4) on K1's inputs: rows [G,9] f32, gauss_ids [B] i32
    in (tile, depth) order, tile_bounds [n_tiles+1] i32 over 16x16 tiles →
    (rgb [3,H,W], final_T [H,W], last_contrib [H,W] i32)."""
    if level not in range(len(LEVELS)):
        raise ValueError(f"blend_variant: level must be 0-{len(LEVELS) - 1}, "
                         f"got {level}")
    tiles_x, n_tiles = _grid(width, height)
    _check_lists("blend_variant", rows, gauss_ids, tile_bounds, n_tiles,
                 width, height)
    if rows.device.type == "cpu":
        return blend_variant_reference(level, rows, gauss_ids, tile_bounds,
                                       width, height, t_eps)
    rgb = torch.empty((3, height, width), dtype=torch.float32,
                      device=rows.device)
    final_t = torch.empty((height, width), dtype=torch.float32,
                          device=rows.device)
    last = torch.empty((height, width), dtype=torch.int32, device=rows.device)
    if n_tiles == 0:
        return rgb, final_t, last
    fn = c_function(SOURCE, "blend_variant", ARGTYPES)
    err = launch(fn, rows.device, level, rows.data_ptr(),
                 gauss_ids.data_ptr(), tile_bounds.data_ptr(), width, height,
                 tiles_x, n_tiles, t_eps, rgb.data_ptr(), final_t.data_ptr(),
                 last.data_ptr())
    if err != 0:
        raise RuntimeError(f"blend_variant: kernel launch of level {level} "
                           f"failed with CUDA error {err}")
    launches[level] += 1
    return rgb, final_t, last


def blocks_per_sm(level: int) -> int:
    """The blocks of K4's `level` one SM of the current card can hold, by
    CUDA's occupancy calculator (registers and shared memory)."""
    fn = c_function(SOURCE, "blend_variant_blocks_per_sm",
                    [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    blocks = ctypes.c_int(0)
    err = fn(level, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"blocks_per_sm: CUDA error {err} at level "
                           f"{level}")
    return blocks.value


def run_variant(level: int, rows, gauss_ids, tile_bounds, width: int,
                height: int, iters: int = ITERS) -> float:
    """ms a call of `blend_variant` at `level`, over `iters` back-to-back
    calls after a warm-up (CUDA events on the card)."""
    return time_ms(lambda: blend_variant(level, rows, gauss_ids, tile_bounds,
                                         width, height), rows.device, iters)


def run_all(device=None, *, tiles_x: int = TILES_X, tiles_y: int = TILES_Y,
            budget: int = BUDGET, iters: int = ITERS, seed: int = 0) -> dict:
    """The lab's table: {"1x3600": [ms of v0 ... v4], "2x3600": ...,
    "8x450": ...} on the lab's instance table (names as chunks x active
    tiles)."""
    dev = resolve_device(device)
    n_tiles = tiles_x * tiles_y
    table = {}
    for cpt, every in CONFIGS:
        active = n_tiles // every
        rows, ids, bounds = lab_inputs(cpt, active, seed, tiles_x=tiles_x,
                                       tiles_y=tiles_y, budget=budget,
                                       device=dev)
        table[f"{cpt}x{active}"] = [
            run_variant(level, rows, ids, bounds, 16 * tiles_x, 16 * tiles_y,
                        iters) for level in range(len(LEVELS))]
    return table


def main(device=None) -> dict:
    """Print the lab's table, one row a level, ms a call."""
    dev = resolve_device(device)
    table = run_all(dev)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"kvariants on {where}: ms a call, mean of {ITERS} calls")
    for level, name in enumerate(LEVELS):
        print(f"{name:18s}" + "   ".join(f"{cfg}: {ms[level]:8.4f}"
                                        for cfg, ms in table.items()))
    return table


if __name__ == "__main__":
    main()
