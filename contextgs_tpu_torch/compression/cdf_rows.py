"""The codec's CDF rows built on a CUDA card: `cdf_rows` wraps
`csrc/cdf_rows.cu`.

For each element (μ, σ, Q float32, window base int64) and the window w, the
uint16 row of w + 1 entries that the range coder codes the element with,
and where asked the float64 row it was quantized from: bit for bit what the
plain version gives, `codec._windowed_cdf_rows` and then
`coder.quantize_cdf` on the host (the note in the source says how). The
kernel replaces no TPU kernel: the JAX package builds these rows on the
host too.

`compression/codec._cdf_rows` calls this for a codec whose device is a CUDA
device, and the plain version otherwise; there is no other switch, and no
fallback from one to the other. `launches` counts the kernel's launches in
this process (one a call).

A call copies its inputs to the card in one copy from pinned host memory,
launches the kernel once (`build_on_card`), and copies the rows and the
blocks' degenerate flags back in one copy into pinned host memory, which
the returned array keeps. The float64 rows cross only where `float_rows`
asks for them (the encoder's bit audit). The widest window is the codec's
(`codec.MAX_WINDOW`); the kernel refuses a wider one at launch.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from contextgs_tpu_torch.ops.cuda_build import c_function, launch
from contextgs_tpu_torch.utils import trace

SOURCE = Path(__file__).resolve().parent / "csrc" / "cdf_rows.cu"
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int] + [
    ctypes.c_void_p] * 4
BLOCKS_ARGTYPES = [ctypes.c_longlong, ctypes.c_int]

launches = 0


def build_on_card(inputs: torch.Tensor, n: int, w: int,
                  float_rows: bool = False) -> tuple:
    """One launch on `inputs`, the elements' bytes on the card (base int64,
    then μ, σ, Q float32, each [n]): (the uint16 rows [n, w+1] followed by
    one int32 degenerate flag a block, as bytes; byte offset of the flags;
    float64 rows [n, w+1] or None), all on the card."""
    global launches
    fn = c_function(SOURCE, "cdf_rows", ARGTYPES)
    n_blocks = c_function(SOURCE, "cdf_rows_blocks", BLOCKS_ARGTYPES)(n, w)
    row_bytes = n * (w + 1) * 2
    flags_at = -(-row_bytes // 4) * 4
    out = torch.empty(flags_at + 4 * n_blocks, dtype=torch.uint8,
                      device=inputs.device)
    fout = (torch.empty((n, w + 1), dtype=torch.float64, device=inputs.device)
            if float_rows else None)
    ptr = inputs.data_ptr()
    err = launch(fn, inputs.device, ptr, ptr + 8 * n, ptr + 12 * n,
                 ptr + 16 * n, n, w, out.data_ptr(),
                 None if fout is None else fout.data_ptr(),
                 out.data_ptr() + flags_at)
    if err != 0:
        raise RuntimeError(f"cdf_rows: kernel launch failed with CUDA error "
                           f"{err}")
    launches += 1
    return out, flags_at, fout


def cdf_rows(mean: np.ndarray, scale: np.ndarray, q: np.ndarray,
             base: np.ndarray, w: int, device: torch.device,
             float_rows: bool = False) -> tuple:
    """(float64 rows [n, w+1] or None, uint16 rows [n, w+1]) of the
    elements, built on the CUDA `device`; raises ValueError("degenerate CDF
    row") where quantize_cdf would."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"cdf_rows: a CUDA device, got {device}")
    n = mean.shape[0]
    for name, x, dtype in (("mean", mean, np.float32),
                           ("scale", scale, np.float32),
                           ("q", q, np.float32), ("base", base, np.int64)):
        if x.dtype != dtype or x.shape != (n,):
            raise ValueError(f"cdf_rows: {name} must be [{n}] {dtype.__name__}"
                             f", got {x.shape} {x.dtype}")
    if n == 0:
        return (np.zeros((0, w + 1)) if float_rows else None,
                np.zeros((0, w + 1), np.uint16))
    staged = torch.empty(20 * n, dtype=torch.uint8, pin_memory=True)
    host = staged.numpy()
    host[:8 * n].view(np.int64)[:] = base
    for j, x in enumerate((mean, scale, q)):
        host[(8 + 4 * j) * n:(12 + 4 * j) * n].view(np.float32)[:] = x
    out, flags_at, fout = build_on_card(
        staged.to(device, non_blocking=True), n, w, float_rows)
    back = torch.empty(out.numel(), dtype=torch.uint8, pin_memory=True)
    back.copy_(out, non_blocking=True)
    with trace.sync("codec.cdf_rows"):
        torch.cuda.current_stream(device).synchronize()
    got = back.numpy()
    if got[flags_at:].view(np.int32).any():
        raise ValueError("degenerate CDF row")
    rows = got[:n * (w + 1) * 2].view(np.uint16).reshape(n, w + 1)
    return (None if fout is None else fout.cpu().numpy()), rows
