"""Blend math shared by the plain rasterizer and the CUDA kernel's checks
(port of `contextgs_tpu/ops/rasterize/common.py`).

Gaussian weight G = exp(power) with power ≤ 0, alpha = min(0.99, opacity·G),
alphas below 1/255 are skipped, and blending stops once transmittance would
fall below 1e-4 (the culprit instance excluded). The same constants are
written into `csrc/blend_forward.cu`.
"""

from __future__ import annotations

import torch

ALPHA_EPS = 1.0 / 255.0
T_EPS = 1e-4
MAX_ALPHA = 0.99


def alpha_from_power(power: torch.Tensor, opacity: torch.Tensor) -> torch.Tensor:
    """power + opacity → blend alpha with the CUDA reference's skip rules."""
    gauss = torch.exp(power)
    alpha = torch.clamp(opacity * gauss, max=MAX_ALPHA)
    alpha = torch.where(power > 0.0, 0.0, alpha)       # outside-ellipse guard
    alpha = torch.where(alpha < ALPHA_EPS, 0.0, alpha)
    return alpha


def gaussian_power(dx, dy, conic_a, conic_b, conic_c):
    """-0.5 dᵀ Conic d with d = mean2d - pixel (broadcasting ok)."""
    return -0.5 * (conic_a * dx * dx + conic_c * dy * dy) - conic_b * dx * dy
