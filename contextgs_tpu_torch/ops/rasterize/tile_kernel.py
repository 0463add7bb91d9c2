"""The tile-blend kernels: K1, the forward, wrapping `csrc/blend_forward.cu`
(replaces `contextgs_tpu/ops/rasterize/tile_kernel.py::blend_forward_pallas`),
and K2, its backward, wrapping `csrc/blend_backward.cu` (replaces
`blend_backward_pallas`).

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else. On a CUDA tensor it then launches its hand-written kernel, or
raises; on a CPU tensor it runs the kernel's plain version,
`reference.blend_tiles_reference` and
`reference.blend_tiles_backward_reference`. It never falls back from one to
the other. `launches` and `backward_launches` count the kernels' launches in
this process.

Both take the Pallas kernels' `row_offset`: the tiles are then a horizontal
band of the image that starts at that tile row, `height` is the band's
height and the outputs hold the band's rows. The offset enters the pixel
coordinates in integer tile arithmetic, so a banded pixel blends the same
float32 values as the same pixel without a band.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from contextgs_tpu_torch.ops.cuda_build import c_function, launch
from contextgs_tpu_torch.ops.rasterize.common import T_EPS
from contextgs_tpu_torch.ops.rasterize.reference import (
    blend_tiles_backward_reference, blend_tiles_reference)

SOURCE = Path(__file__).resolve().parent / "csrc" / "blend_forward.cu"
BACKWARD_SOURCE = SOURCE.with_name("blend_backward.cu")
SOURCES = (SOURCE, BACKWARD_SOURCE)
TILE = 16          # the kernels' tile side: one 256-thread block per tile
ROW = 9            # mean xy, conic abc, opacity, rgb
FORWARD_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                    + [ctypes.c_float] + [ctypes.c_void_p] * 4)
BACKWARD_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                     + [ctypes.c_void_p] * 2)

launches = 0
backward_launches = 0


def _check(name: str, device, tensors) -> None:
    """Raise unless every (label, tensor, dtype, shape) lies contiguous on
    `device` with that dtype and shape."""
    for label, x, dtype, shape in tensors:
        if x.device != device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name}: {label} must be a contiguous {dtype} "
                             f"tensor on {device}, got {x.dtype} on "
                             f"{x.device}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name}: {label} must have shape {shape}, got "
                             f"{tuple(x.shape)}")


def _grid(width: int, height: int):
    tiles_x = (width + TILE - 1) // TILE
    tiles_y = (height + TILE - 1) // TILE
    return tiles_x, tiles_x * tiles_y


def _check_lists(name, rows, gauss_ids, tile_bounds, n_tiles, width, height):
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {rows.device}")
    if rows.dim() != 2 or rows.shape[1] != ROW:
        raise ValueError(f"{name}: rows must be [G,{ROW}], "
                         f"got {tuple(rows.shape)}")
    if gauss_ids.dim() != 1 or tuple(tile_bounds.shape) != (n_tiles + 1,):
        raise ValueError(f"{name}: gauss_ids must be 1-D and tile_bounds "
                         f"[{n_tiles + 1}] for {width}x{height}, got "
                         f"{tuple(gauss_ids.shape)} and "
                         f"{tuple(tile_bounds.shape)}")
    _check(name, rows.device, (("rows", rows, torch.float32, None),
                               ("gauss_ids", gauss_ids, torch.int32, None),
                               ("tile_bounds", tile_bounds, torch.int32,
                                None)))


def blend_forward(rows: torch.Tensor, gauss_ids: torch.Tensor,
                  tile_bounds: torch.Tensor, width: int, height: int,
                  t_eps: float = T_EPS, row_offset: int = 0):
    """rows [G,9] f32, gauss_ids [B] i32 in (tile, depth) order, tile_bounds
    [n_tiles+1] i32 over 16x16 tiles → (rgb [3,H,W], final_T [H,W],
    last_contrib [H,W] i32); with `row_offset`, the band of tiles from that
    tile row on."""
    global launches
    tiles_x, n_tiles = _grid(width, height)
    _check_lists("blend_forward", rows, gauss_ids, tile_bounds, n_tiles,
                 width, height)
    if rows.device.type == "cpu":
        return blend_tiles_reference(rows, gauss_ids, tile_bounds, width,
                                     height, tiles_x, TILE, t_eps,
                                     row_offset=row_offset)
    rgb = torch.empty((3, height, width), dtype=torch.float32,
                      device=rows.device)
    final_t = torch.empty((height, width), dtype=torch.float32,
                          device=rows.device)
    last = torch.empty((height, width), dtype=torch.int32, device=rows.device)
    if n_tiles == 0:
        return rgb, final_t, last
    fn = c_function(SOURCE, "blend_forward", FORWARD_ARGTYPES)
    err = launch(fn, rows.device, rows.data_ptr(), gauss_ids.data_ptr(),
                 tile_bounds.data_ptr(), width, height, tiles_x, n_tiles,
                 row_offset, t_eps, rgb.data_ptr(), final_t.data_ptr(),
                 last.data_ptr())
    if err != 0:
        raise RuntimeError(f"blend_forward: kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    return rgb, final_t, last


def blend_backward(rows: torch.Tensor, gauss_ids: torch.Tensor,
                   tile_bounds: torch.Tensor, rgb: torch.Tensor,
                   final_t: torch.Tensor, last_contrib: torch.Tensor,
                   d_rgb: torch.Tensor, d_final_t: torch.Tensor, width: int,
                   height: int, t_eps: float = T_EPS,
                   row_offset: int = 0) -> torch.Tensor:
    """The gradient of `blend_forward`: its inputs and outputs, and the
    cotangents d_rgb [3,H,W] and d_final_t [H,W] f32 → d_rows [G,9] f32.

    K2 reads `last_contrib` for where each pixel stopped; `t_eps` is read
    only by the plain version, which recomputes the forward."""
    global backward_launches
    tiles_x, n_tiles = _grid(width, height)
    _check_lists("blend_backward", rows, gauss_ids, tile_bounds, n_tiles,
                 width, height)
    hw, chw = (height, width), (3, height, width)
    _check("blend_backward", rows.device,
           (("rgb", rgb, torch.float32, chw),
            ("final_t", final_t, torch.float32, hw),
            ("last_contrib", last_contrib, torch.int32, hw),
            ("d_rgb", d_rgb, torch.float32, chw),
            ("d_final_t", d_final_t, torch.float32, hw)))
    if rows.device.type == "cpu":
        return blend_tiles_backward_reference(
            rows, gauss_ids, tile_bounds, rgb, final_t, last_contrib, d_rgb,
            d_final_t, width, height, t_eps, row_offset, TILE)
    d_rows = torch.zeros_like(rows)
    if n_tiles == 0:
        return d_rows
    fn = c_function(BACKWARD_SOURCE, "blend_backward", BACKWARD_ARGTYPES)
    err = launch(fn, rows.device, rows.data_ptr(), gauss_ids.data_ptr(),
                 tile_bounds.data_ptr(), rgb.data_ptr(), final_t.data_ptr(),
                 last_contrib.data_ptr(), d_rgb.data_ptr(),
                 d_final_t.data_ptr(), width, height, tiles_x, n_tiles,
                 row_offset, d_rows.data_ptr())
    if err != 0:
        raise RuntimeError(f"blend_backward: kernel launch failed with CUDA "
                           f"error {err}")
    backward_launches += 1
    return d_rows
