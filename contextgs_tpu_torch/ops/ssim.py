"""Windowed SSIM, PSNR and L1 (port of `contextgs_tpu/ops/ssim.py`).

11x11 Gaussian window (sigma=1.5), per-channel depthwise convolution with
padding window//2, C1=0.01², C2=0.03². The variances are E[x²]−μ², which
cancels badly at reduced precision, so the convolution runs in full float32:
cuDNN's TF32 mode, on by default, is switched off around it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    x = np.arange(window_size, dtype=np.float32) - window_size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    w2d = np.outer(g, g)
    return (w2d / w2d.sum()).astype(np.float32)


def _filter2d(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Depthwise 2D conv, img [C,H,W], window [k,k], padding k//2 each side."""
    c, k = img.shape[0], window.shape[0]
    weight = window[None, None].expand(c, 1, k, k)
    return F.conv2d(img[None], weight, padding=k // 2, groups=c)[0]


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over [C,H,W] images in [0,1]."""
    w = torch.as_tensor(_gaussian_window(window_size, sigma),
                        device=img1.device)
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        mu1 = _filter2d(img1, w)
        mu2 = _filter2d(img2, w)
        mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        # clamp: E[x²]−μ² is ≥ 0 mathematically; float32 rounding can leave
        # a tiny negative residue in perfectly flat windows
        sigma1_sq = torch.clamp(_filter2d(img1 * img1, w) - mu1_sq, min=0.0)
        sigma2_sq = torch.clamp(_filter2d(img2 * img2, w) - mu2_sq, min=0.0)
        sigma12 = _filter2d(img1 * img2, w) - mu12
    finally:
        torch.backends.cudnn.allow_tf32 = allow_tf32
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.abs(a - b).mean()


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """PSNR over [C,H,W] in [0,1]."""
    mse = torch.mean((a - b) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))
