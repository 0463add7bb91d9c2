"""The carry kernel: `segmented_carry` wraps `csrc/carry.cu`, one launch that
computes `models/levels.segmented_carry` on CUDA tensors (it replaces no
Pallas kernel: it stands in for the XLA associative scan of
`contextgs_tpu/models/levels.py::segmented_carry`).

out[i] = values[j] for the latest j ≤ i with is_start[j], and values[0]
before the first start; `is_start` is bool [n], `values` int32 or int64 [n],
both contiguous on one device, n < 2^31 (the kernel's key indices are int32).
`check` raises ValueError on anything else, for either path: the kernel here,
and `models/levels.segmented_carry_plain`, which CPU tensors take. The output
is exact, so the two give equal integers. `launches` counts the wrapper's
launches in this process (one a call with n > 0, one kernel on the stream).

The kernel's scratch (a ticket, a done count and a status word per tile of
8192 keys) is kept per (device, stream) in `_scratch`, allocated zeroed and
grown when a call needs more; each launch leaves it zeroed again, so no call
zeroes it (`cuda_build.scratch`).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from contextgs_tpu_torch.ops.cuda_build import c_function, launch, scratch

SOURCE = Path(__file__).resolve().parent / "csrc" / "carry.cu"
BLOCK = 8192          # keys a CUDA block carries, a tile
MAX_KEYS = 2 ** 31 - 1
FUNCTIONS = {torch.int32: "segmented_carry_i32",
             torch.int64: "segmented_carry_i64"}
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p]

launches = 0
_scratch: dict = {}     # (device index, stream handle) → zeroed int64 words


def check(is_start: torch.Tensor, values: torch.Tensor) -> int:
    """Raise ValueError on what the carry does not take; return n."""
    for name, t in (("is_start", is_start), ("values", values)):
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"segmented_carry: unsupported device {t.device} "
                             f"for {name}")
    if is_start.device != values.device:
        raise ValueError(f"segmented_carry: is_start on {is_start.device}, "
                         f"values on {values.device}")
    if is_start.dim() != 1 or values.dim() != 1:
        raise ValueError(f"segmented_carry: is_start and values must be [n], "
                         f"got {tuple(is_start.shape)} and "
                         f"{tuple(values.shape)}")
    n = is_start.shape[0]
    if values.shape[0] != n:
        raise ValueError(f"segmented_carry: {n} flags for {values.shape[0]} "
                         f"values")
    if n > MAX_KEYS:
        raise ValueError(f"segmented_carry: {n} keys, more than int32 "
                         f"indices address")
    if is_start.dtype != torch.bool:
        raise ValueError(f"segmented_carry: is_start must be bool, got "
                         f"{is_start.dtype}")
    if values.dtype not in FUNCTIONS:
        raise ValueError(f"segmented_carry: values must be int32 or int64, "
                         f"got {values.dtype}")
    if not (is_start.is_contiguous() and values.is_contiguous()):
        raise ValueError("segmented_carry: is_start and values must be "
                         "contiguous")
    return n


def segmented_carry(is_start: torch.Tensor,
                    values: torch.Tensor) -> torch.Tensor:
    """The carry of `values` from the starts in `is_start`, on CUDA tensors
    by one launch of the kernel."""
    global launches
    n = check(is_start, values)
    device = values.device
    if device.type != "cuda":
        raise ValueError("segmented_carry: the kernel takes CUDA tensors; "
                         "CPU tensors take levels.segmented_carry_plain")
    out = torch.empty_like(values)
    if n:
        words = scratch(_scratch, device, -(-n // BLOCK) + 1)
        fn = c_function(SOURCE, FUNCTIONS[values.dtype], ARGTYPES)
        err = launch(fn, device, is_start.data_ptr(), values.data_ptr(),
                     out.data_ptr(), words.data_ptr(), n)
        if err != 0:
            raise RuntimeError(f"segmented_carry: kernel launch failed with "
                               f"CUDA error {err}")
        launches += 1
    return out
