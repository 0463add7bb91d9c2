"""K3, the lane prefix sum: `lane_cumsum` wraps `csrc/scan.cu` (port of
`contextgs_tpu/ops/scan.py`, replacing its Pallas kernel `lane_cumsum`).

An inclusive or exclusive prefix sum along the last axis of a contiguous
[R, N] or [N] tensor of int32, uint32 or float32. int32 adds wrap as two's
complement, as `np.cumsum(dtype=np.int32)` does; uint32 is taken as int32,
since the adds are the same bits mod 2^32. On a CUDA tensor the wrapper
launches K3 or raises; on a CPU tensor it runs the plain version,
`lane_cumsum_reference`. It never falls back from one to the other.
`launches` counts the wrapper's launches of K3 in this process (one a call;
K3 is three kernels on the stream).

Float32 sums run in another order than `torch.cumsum`'s: each output of K3
is within `float_tolerance(N)` · Σ_{j≤i}|x_j| of the exact prefix (the note
in `csrc/scan.cu` counts the additions).

The rasterizer's own prefix sums are `torch.cumsum`, as the reference's are
`jnp.cumsum`: K3 is off the main path, like its TPU counterpart.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from contextgs_tpu_torch.ops.cuda_build import c_function

SOURCE = Path(__file__).resolve().parent / "csrc" / "scan.cu"
BLOCK = 4096          # elements a CUDA block scans, the TPU LANE_BLOCK
MAX_ROWS = 65535      # rows go on the grid's y dimension
DTYPES = (torch.int32, torch.uint32, torch.float32)

launches = 0


def float_tolerance(n: int) -> float:
    """Float32 error bound of K3 for rows of length n, in units of
    Σ_{j≤i}|x_j|: D · 2^-24 with D = 64 + ⌈n / 2^20⌉ the most additions an
    element goes through."""
    return (64 + math.ceil(n / 2 ** 20)) * 2.0 ** -24


def lane_cumsum_reference(x: torch.Tensor,
                          exclusive: bool = False) -> torch.Tensor:
    """The plain version: `torch.cumsum` in x's own dtype (by default it
    would promote int32 to int64), shifted right by one for `exclusive`."""
    out = torch.cumsum(x, -1, dtype=x.dtype)
    if exclusive:
        out = torch.cat([torch.zeros_like(out[..., :1]), out[..., :-1]], -1)
    return out


def lane_cumsum(x: torch.Tensor, exclusive: bool = False) -> torch.Tensor:
    """Prefix sum along the last axis of x [R, N] or [N]."""
    global launches
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lane_cumsum: unsupported device {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"lane_cumsum: dtype must be one of {DTYPES}, got "
                         f"{x.dtype}")
    if x.dim() not in (1, 2):
        raise ValueError(f"lane_cumsum: x must be [N] or [R,N], got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("lane_cumsum: x must be contiguous")
    unsigned = x.dtype == torch.uint32
    if unsigned:
        x = x.view(torch.int32)
    if x.device.type == "cpu":
        out = lane_cumsum_reference(x, exclusive)
        return out.view(torch.uint32) if unsigned else out

    rows = x.view(1, -1) if x.dim() == 1 else x
    r, n = rows.shape
    if r > MAX_ROWS:
        raise ValueError(f"lane_cumsum: at most {MAX_ROWS} rows, got {r}")
    out = torch.empty_like(x)
    if r and n:
        partial = torch.empty((r, -(-n // BLOCK)), dtype=x.dtype,
                              device=x.device)
        name = ("lane_cumsum_f32" if x.dtype == torch.float32
                else "lane_cumsum_i32")
        fn = c_function(SOURCE, name, [ctypes.c_void_p] * 3
                        + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_void_p])
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(rows.data_ptr(), out.data_ptr(), partial.data_ptr(), r,
                     n, int(exclusive), stream)
        if err != 0:
            raise RuntimeError(f"lane_cumsum: kernel launch failed with CUDA "
                               f"error {err}")
        launches += 1
    return out.view(torch.uint32) if unsigned else out
