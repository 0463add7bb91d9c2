"""K1, the tile-blend forward: wrapper of `csrc/blend_forward.cu` (replaces
`contextgs_tpu/ops/rasterize/tile_kernel.py::blend_forward_pallas`).

On a CUDA tensor the wrapper launches the hand-written kernel, or raises; on
a CPU tensor it runs the kernel's plain version,
`reference.blend_tiles_reference`. It never falls back from one to the other.
`launches` counts the kernel's launches in this process.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from contextgs_tpu_torch.ops.cuda_build import load_library
from contextgs_tpu_torch.ops.rasterize.common import T_EPS
from contextgs_tpu_torch.ops.rasterize.reference import blend_tiles_reference

SOURCE = Path(__file__).resolve().parent / "csrc" / "blend_forward.cu"
TILE = 16          # the kernel's tile side: one 256-thread block per tile
ROW = 9            # mean xy, conic abc, opacity, rgb

launches = 0


def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.blend_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_float] + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
    return lib


def blend_forward(rows: torch.Tensor, gauss_ids: torch.Tensor,
                  tile_bounds: torch.Tensor, width: int, height: int,
                  t_eps: float = T_EPS):
    """rows [G,9] f32, gauss_ids [B] i32 in (tile, depth) order, tile_bounds
    [n_tiles+1] i32 over 16x16 tiles → (rgb [3,H,W], final_T [H,W],
    last_contrib [H,W] i32)."""
    global launches
    tiles_x = (width + TILE - 1) // TILE
    tiles_y = (height + TILE - 1) // TILE
    n_tiles = tiles_x * tiles_y
    if rows.device.type == "cpu":
        return blend_tiles_reference(rows, gauss_ids, tile_bounds, width,
                                     height, tiles_x, TILE, t_eps)
    if rows.device.type != "cuda":
        raise ValueError(f"blend_forward: unsupported device {rows.device}")
    for name, x, dtype in (("rows", rows, torch.float32),
                           ("gauss_ids", gauss_ids, torch.int32),
                           ("tile_bounds", tile_bounds, torch.int32)):
        if x.device != rows.device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"blend_forward: {name} must be a contiguous "
                             f"{dtype} tensor on {rows.device}, got "
                             f"{x.dtype} on {x.device}")
    if rows.dim() != 2 or rows.shape[1] != ROW:
        raise ValueError(f"blend_forward: rows must be [G,{ROW}], "
                         f"got {tuple(rows.shape)}")
    if gauss_ids.dim() != 1 or tuple(tile_bounds.shape) != (n_tiles + 1,):
        raise ValueError(f"blend_forward: gauss_ids must be 1-D and "
                         f"tile_bounds [{n_tiles + 1}] for {width}x{height}, "
                         f"got {tuple(gauss_ids.shape)} and "
                         f"{tuple(tile_bounds.shape)}")
    rgb = torch.empty((3, height, width), dtype=torch.float32,
                      device=rows.device)
    final_t = torch.empty((height, width), dtype=torch.float32,
                          device=rows.device)
    last = torch.empty((height, width), dtype=torch.int32, device=rows.device)
    if n_tiles == 0:
        return rgb, final_t, last
    lib = _library()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = lib.blend_forward(rows.data_ptr(), gauss_ids.data_ptr(),
                                tile_bounds.data_ptr(), width, height, tiles_x,
                                n_tiles, t_eps, rgb.data_ptr(),
                                final_t.data_ptr(), last.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"blend_forward: kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    return rgb, final_t, last
