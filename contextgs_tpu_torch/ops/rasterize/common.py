"""Blend math shared by the plain rasterizer and the CUDA kernel's checks
(port of `contextgs_tpu/ops/rasterize/common.py`).

Gaussian weight G = exp(power) with power ≤ 0, alpha = min(0.99, opacity·G),
alphas below 1/255 are skipped, and blending stops once transmittance would
fall below 1e-4 (the culprit instance excluded). The same constants are
written into `csrc/blend_forward.cu`. `alpha_footprint` is the
specification of K2's cull (`csrc/blend_backward.cu` copies it).
"""

from __future__ import annotations

import torch

ALPHA_EPS = 1.0 / 255.0
T_EPS = 1e-4
MAX_ALPHA = 0.99
# alpha_footprint's margins: the slack on tau, relative and absolute; the
# share of a·c held back from det; the pixels added to each half-extent
FOOTPRINT_TAU_SLACK = 1e-4
FOOTPRINT_DET_SLACK = 1e-5
FOOTPRINT_MARGIN = 1.0


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


def alpha_footprint(conic: torch.Tensor, opacity: torch.Tensor):
    """Conservative reach of a splat's alpha ≥ 1/255 region: conic [..., 3]
    (a, b, c) and opacity [...] float32 → (rx, ry, tau) float32 [...].

    With M = [[a, b], [b, c]] and d = mean - pixel, the power is -dᵀMd/2,
    and alpha ≥ 1/255 needs power ≥ -ln(255·opacity). Every pixel whose
    alpha the blend computes in float32 as ≥ 1/255 lies within rx of the
    mean in x and ry in y, and has power ≥ -tau:
    - tau = max(ln(255·op), 0)·(1 + 1e-4) + 1e-4 covers the rounding of
      the log, of exp (2 ulp in CUDA's expf) and of op·exp, and of the
      1/255 constant;
    - the rounding of the power, at most 6 ulps of a·dx² + c·dy² +
      2|b·dx·dy| ≤ 2(a·dx² + c·dy²), is taken into M by shrinking its
      diagonal by 2ε (ε = 16 ulps); the box of the shrunk form is
      sqrt(2·tau·c/det) by sqrt(2·tau·a/det), det = a·c·(1 - 1e-5) - b²,
      which rounds below the shrunk form's determinant;
    - one pixel more on each half-extent covers the rounding of the box.
    An opacity under 1/255 blends nowhere: rx = ry = -inf (empty box). A
    conic that is not positive definite (det ≤ 0 or a ≤ 0, or NaN) gets no
    box: rx = ry = +inf. A NaN opacity gives NaN, which culls nothing."""
    a, b, c = conic.unbind(-1)
    tau = (torch.log(255.0 * opacity).clamp_min(0.0)
           * (1.0 + FOOTPRINT_TAU_SLACK) + FOOTPRINT_TAU_SLACK)
    det = a * c * (1.0 - FOOTPRINT_DET_SLACK) - b * b
    rx = torch.sqrt(2.0 * tau * c / det) + FOOTPRINT_MARGIN
    ry = torch.sqrt(2.0 * tau * a / det) + FOOTPRINT_MARGIN
    inf = float("inf")
    rx = torch.where((det > 0.0) & (a > 0.0), rx, inf)
    ry = torch.where((det > 0.0) & (a > 0.0), ry, inf)
    blends_nowhere = opacity < ALPHA_EPS
    return (torch.where(blends_nowhere, -inf, rx),
            torch.where(blends_nowhere, -inf, ry), tau)
