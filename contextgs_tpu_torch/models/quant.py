"""Quantizers, forward values (port of `contextgs_tpu/models/quant.py`).

The straight-through form `x + (q(x) - x).detach()` is kept as written in the
reference, so that the forward value is rounded exactly as JAX rounds it (it
is not always bit-equal to q(x)).
"""

from __future__ import annotations

import torch

ANCHOR_ROUND_DIGITS = 16
Q_ANCHOR = 1.0 / (2 ** ANCHOR_ROUND_DIGITS - 1)


def quantize_anchor(anchors: torch.Tensor, min_v: torch.Tensor,
                    max_v: torch.Tensor):
    """16-bit uniform quantization of anchor xyz into [min_v, max_v] with STE.

    Returns (dequantized anchors, integer codes). Every constant is a float32
    tensor, so the op order and rounding are those of the reference."""
    f32 = dict(dtype=torch.float32, device=anchors.device)
    interval = (max_v - min_v) * torch.tensor(Q_ANCHOR, **f32) \
        + torch.tensor(1e-6, **f32)
    codes = torch.clamp(torch.floor((anchors - min_v) / interval),
                        0, 2 ** ANCHOR_ROUND_DIGITS - 1)
    deq = codes * interval + min_v
    return anchors + (deq - anchors).detach(), codes.detach().to(torch.int64)


def mask_ste(mask_logit: torch.Tensor, threshold: float = 0.01) -> torch.Tensor:
    """Hard binary mask (sigmoid(m) > thresh) with sigmoid-gradient STE."""
    s = torch.sigmoid(mask_logit)
    hard = (s > threshold).to(mask_logit.dtype)
    return s + (hard - s).detach()
