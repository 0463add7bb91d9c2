"""Device selection for the port's entry points.

Entry points that create tensors take `device=None`, which means the CUDA
card. Without a card they raise instead of dropping to the CPU; the CPU runs
only when the caller asks for it with `device="cpu"`.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` → `cuda`; raise if a CUDA device is asked for and none exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "contextgs_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return dev
