"""Windowed SSIM, PSNR and L1 (port of `contextgs_tpu/ops/ssim.py`).

11x11 Gaussian window (sigma=1.5), per-channel depthwise convolution with
padding window//2, C1=0.01², C2=0.03². The variances are E[x²]−μ², which
cancels badly at reduced precision, so the convolution runs in full float32
in the forward and in the backward: it is an autograd Function whose two
passes each switch cuDNN's TF32 mode, on by default, off around their
convolution (autograd runs the backward after the forward has returned, so a
switch around the forward alone would leave the gradient in TF32). PyTorch
may run this depthwise convolution with its own kernel, which has no TF32
mode; the switch holds wherever cuDNN is chosen instead.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from contextgs_tpu_torch.utils import trace


def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    x = np.arange(window_size, dtype=np.float32) - window_size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    w2d = np.outer(g, g)
    return (w2d / w2d.sum()).astype(np.float32)


@contextlib.contextmanager
def full_float32():
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = allow_tf32


def _depthwise(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    c, k = img.shape[0], window.shape[0]
    weight = window[None, None].expand(c, 1, k, k)
    with full_float32():
        return F.conv2d(img[None], weight, padding=k // 2, groups=c)[0]


class _Filter2d(torch.autograd.Function):
    """Depthwise 2D conv of img [C,H,W] with a constant odd window [k,k],
    zero padding k//2 each side. Its adjoint is the same convolution with
    the window flipped."""

    @staticmethod
    def forward(ctx, img, window):
        ctx.save_for_backward(window)
        return _depthwise(img, window)

    @staticmethod
    def backward(ctx, grad):
        (window,) = ctx.saved_tensors
        return _depthwise(grad.contiguous(), window.flip(0, 1)), None


def _filter2d(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Depthwise 2D conv, img [C,H,W], window [k,k], padding k//2 each side."""
    return _Filter2d.apply(img, window)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over [C,H,W] images in [0,1]."""
    with trace.sync("ssim.window"):
        w = torch.as_tensor(_gaussian_window(window_size, sigma),
                            dtype=img1.dtype, device=img1.device)
    mu1 = _filter2d(img1, w)
    mu2 = _filter2d(img2, w)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    # clamp: E[x²]−μ² is ≥ 0 mathematically; float32 rounding can leave
    # a tiny negative residue in perfectly flat windows
    sigma1_sq = torch.clamp(_filter2d(img1 * img1, w) - mu1_sq, min=0.0)
    sigma2_sq = torch.clamp(_filter2d(img2 * img2, w) - mu2_sq, min=0.0)
    sigma12 = _filter2d(img1 * img2, w) - mu12
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
