"""Straight-through quantizers (port of `contextgs_tpu/models/quant.py`).

The straight-through form `x + (q(x) - x).detach()` is kept as written in the
reference, so that the forward value is rounded exactly as JAX rounds it (it
is not always bit-equal to q(x)), and the gradient is the identity.
Training noise comes from an explicit `torch.Generator`; every draw goes
through `_uniform`, so a test can hand both packages the same numbers.
"""

from __future__ import annotations

import torch

from contextgs_tpu_torch.utils import trace

ANCHOR_ROUND_DIGITS = 16
Q_ANCHOR = 1.0 / (2 ** ANCHOR_ROUND_DIGITS - 1)
CLAMP_STEPS = 15_000  # the ±15000·Q clamp window of ste_multistep


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round(x) with identity gradient."""
    return x + (torch.round(x) - x).detach()


def ste_multistep(x: torch.Tensor, q, x_mean=None) -> torch.Tensor:
    """round(x/Q)·Q with STE and the ±15000·Q clamp; `x_mean` recentres the
    clamp window (None clamps around 0)."""
    lo = -CLAMP_STEPS * q
    hi = CLAMP_STEPS * q
    if x_mean is not None:
        lo, hi = x_mean + lo, x_mean + hi
    if isinstance(lo, torch.Tensor):
        lo, hi = lo.detach(), hi.detach()
    x = torch.clamp(x, lo, hi)
    return x + (torch.round(x / q) * q - x).detach()


def _uniform(shape, generator: torch.Generator | None,
             device) -> torch.Tensor:
    """U[0,1) float32 draws of `shape` from `generator` on `device`."""
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=device)


def uniform_noise_quant(x: torch.Tensor, q,
                        generator: torch.Generator | None) -> torch.Tensor:
    """Training-time quantization surrogate: x + U(-Q/2, Q/2)."""
    return x + (_uniform(x.shape, generator, x.device) - 0.5) * q


def ste_binary(x: torch.Tensor) -> torch.Tensor:
    """sign(x) ∈ {−1,+1}; the gradient passes only inside [−1,1]."""
    out = torch.where(x >= 0, 1.0, -1.0).to(x.dtype)
    mask = (torch.abs(x) <= 1.0).to(x.dtype)
    return x * mask + (out - x * mask).detach()


def quantize_anchor(anchors: torch.Tensor, min_v: torch.Tensor,
                    max_v: torch.Tensor):
    """16-bit uniform quantization of anchor xyz into [min_v, max_v] with STE.

    Returns (dequantized anchors, integer codes). Every constant is a float32
    tensor, so the op order and rounding are those of the reference."""
    f32 = dict(dtype=torch.float32, device=anchors.device)
    with trace.sync("quant.consts", 2):
        q_anchor = torch.tensor(Q_ANCHOR, **f32)
        eps = torch.tensor(1e-6, **f32)
    interval = (max_v - min_v) * q_anchor + eps
    codes = torch.clamp(torch.floor((anchors - min_v) / interval),
                        0, 2 ** ANCHOR_ROUND_DIGITS - 1)
    deq = codes * interval + min_v
    return anchors + (deq - anchors).detach(), codes.detach().to(torch.int64)


def mask_ste(mask_logit: torch.Tensor, threshold: float = 0.01) -> torch.Tensor:
    """Hard binary mask (sigmoid(m) > thresh) with sigmoid-gradient STE."""
    s = torch.sigmoid(mask_logit)
    hard = (s > threshold).to(mask_logit.dtype)
    return s + (hard - s).detach()
