"""K3, the lane prefix sum: `lane_cumsum` wraps `csrc/scan.cu` (port of
`contextgs_tpu/ops/scan.py`, replacing its Pallas kernel `lane_cumsum`).

An inclusive or exclusive prefix sum along the last axis of a contiguous
[R, N] or [N] tensor of int32, uint32 or float32. int32 adds wrap as two's
complement, as `np.cumsum(dtype=np.int32)` does; uint32 is taken as int32,
since the adds are the same bits mod 2^32. On a CUDA tensor the wrapper
launches K3 or raises; on a CPU tensor it runs the plain version,
`lane_cumsum_reference`. It never falls back from one to the other.
`launches` counts the wrapper's launches of K3 in this process (one a call,
one kernel on the stream).

The call is lean on the host, where a prefix sum of a view's tile counts
spends most of its time: the C function is looked up once, the device is
entered only when it is not the current one, and the only allocation is
the output. K3's scratch (a ticket, a done count and a status word per
tile) is kept per (device, stream) in `_scratch`, allocated zeroed and
grown when a call needs more; each launch leaves it zeroed again (its last
block clears it), and launches on one stream run in order, so no call
zeroes or allocates it.

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

from contextgs_tpu_torch.ops.cuda_build import c_function, launch, scratch

SOURCE = Path(__file__).resolve().parent / "csrc" / "scan.cu"
BLOCK = 8192          # elements a CUDA block scans, a tile
MAX_ROWS = 65535      # rows a call
DTYPES = (torch.int32, torch.uint32, torch.float32)
ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                    ctypes.c_int, ctypes.c_void_p]

launches = 0
_scratch: dict = {}     # (device index, stream handle) → zeroed int64 words


def float_tolerance(n: int) -> float:
    """Float32 error bound of K3 for rows of length n, in units of
    Σ_{j≤i}|x_j|: D · 2^-24 with D = 80 + ⌈n / 8192⌉ the most additions an
    element goes through, one a tile of the look-back chain at most."""
    return (80 + math.ceil(n / BLOCK)) * 2.0 ** -24


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
    device, dtype = x.device, x.dtype
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"lane_cumsum: unsupported device {device}")
    if dtype not in DTYPES:
        raise ValueError(f"lane_cumsum: dtype must be one of {DTYPES}, got "
                         f"{dtype}")
    shape = x.shape
    if len(shape) not in (1, 2):
        raise ValueError(f"lane_cumsum: x must be [N] or [R,N], got "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError("lane_cumsum: x must be contiguous")
    unsigned = dtype == torch.uint32
    if unsigned:
        x = x.view(torch.int32)
    if device.type == "cpu":
        out = lane_cumsum_reference(x, exclusive)
        return out.view(torch.uint32) if unsigned else out

    r, n = (1, shape[0]) if len(shape) == 1 else shape
    if r > MAX_ROWS:
        raise ValueError(f"lane_cumsum: at most {MAX_ROWS} rows, got {r}")
    out = torch.empty_like(x)
    if r and n:
        words = scratch(_scratch, device, r * -(-n // BLOCK) + 1)
        fn = c_function(SOURCE, "lane_cumsum_f32" if dtype == torch.float32
                        else "lane_cumsum_i32", ARGTYPES)
        err = launch(fn, device, x.data_ptr(), out.data_ptr(),
                     words.data_ptr(), r, n, int(exclusive))
        if err != 0:
            raise RuntimeError(f"lane_cumsum: kernel launch failed with CUDA "
                               f"error {err}")
        launches += 1
    return out.view(torch.uint32) if unsigned else out
