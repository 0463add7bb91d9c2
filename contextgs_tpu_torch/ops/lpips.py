"""LPIPS perceptual metric, VGG16 features and linear heads (port of
`contextgs_tpu/ops/lpips.py`).

The metric is gated as in the JAX package: no weights are fetched, and
`load_weights` reads the `.npz` that `CONTEXTGS_LPIPS_WEIGHTS` names (the
keys the JAX package's `export_weights_from_torch` writes: `conv{i}_w` as
[kh, kw, cin, cout], `conv{i}_b`, `lin{j}`), or returns None.
`random_weights` exists for tests of the scoring math. The convolutions run
in full float32 (cuDNN's TF32 off, as in `ops/ssim.py`), so that the card
agrees with the CPU.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from contextgs_tpu_torch.ops.ssim import full_float32

# VGG16 blocks up to relu1_2, relu2_2, relu3_3, relu4_3, relu5_3: (convs, ch)
_VGG_CFG = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]
# LPIPS' ScalingLayer
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LPIPSWeights(NamedTuple):
    convs: tuple     # ((w [cout, cin, 3, 3], b [cout]), ...)
    lins: tuple      # per-stage 1x1 weights [c] (non-negative)


def load_weights(path: Optional[str] = None,
                 device="cpu") -> Optional[LPIPSWeights]:
    """The weights of the `.npz` at `path` (default: $CONTEXTGS_LPIPS_WEIGHTS)
    on `device`, or None where there is no such file."""
    path = path or os.environ.get("CONTEXTGS_LPIPS_WEIGHTS", "")
    if not path or not os.path.exists(path):
        return None
    with np.load(path) as data:
        convs = []
        i = 0
        while f"conv{i}_w" in data:
            w = np.ascontiguousarray(data[f"conv{i}_w"].transpose(3, 2, 0, 1))
            convs.append((torch.from_numpy(w).to(device),
                          torch.from_numpy(data[f"conv{i}_b"]).to(device)))
            i += 1
        lins = tuple(torch.from_numpy(data[f"lin{j}"]).to(device)
                     for j in range(len(_VGG_CFG)))
    return LPIPSWeights(convs=tuple(convs), lins=lins)


def random_weights(generator: torch.Generator,
                   device="cpu") -> LPIPSWeights:
    """Random weights drawn from `generator` (a CPU generator), for tests of
    the scoring math only."""
    convs = []
    cin = 3
    for n_convs, cout in _VGG_CFG:
        for _ in range(n_convs):
            w = torch.randn((cout, cin, 3, 3), generator=generator) * 0.05
            convs.append((w.to(device), torch.zeros(cout, device=device)))
            cin = cout
    lins = tuple(
        (torch.randn(c, generator=generator).abs() * 0.01).to(device)
        for _, c in _VGG_CFG)
    return LPIPSWeights(convs=tuple(convs), lins=lins)


def _vgg_features(w: LPIPSWeights, x: torch.Tensor) -> list:
    """x [3,H,W] in [0,1] → the 5 stage activations [C,h,w]."""
    shift = torch.as_tensor(_SHIFT, device=x.device)[:, None, None]
    scale = torch.as_tensor(_SCALE, device=x.device)[:, None, None]
    h = (((x * 2 - 1) - shift) / scale)[None]
    feats = []
    ci = 0
    for bi, (n_convs, _) in enumerate(_VGG_CFG):
        for _ in range(n_convs):
            wgt, b = w.convs[ci]
            h = F.relu(F.conv2d(h, wgt, b, padding=1))
            ci += 1
        feats.append(h[0])
        if bi < len(_VGG_CFG) - 1:
            h = F.max_pool2d(h, 2, 2)
    return feats


@torch.no_grad()
def lpips(w: LPIPSWeights, img1: torch.Tensor,
          img2: torch.Tensor) -> torch.Tensor:
    """LPIPS distance between [3,H,W] images in [0,1]: unit-normalized
    channel features, squared difference, 1x1 linear head, spatial mean,
    summed over the stages."""
    with full_float32():
        f1 = _vgg_features(w, img1)
        f2 = _vgg_features(w, img2)
    total = torch.zeros((), device=img1.device)
    for a, b, lin in zip(f1, f2, w.lins):
        na = a / torch.clamp(torch.linalg.norm(a, dim=0, keepdim=True), 1e-10)
        nb = b / torch.clamp(torch.linalg.norm(b, dim=0, keepdim=True), 1e-10)
        total = total + torch.mean(
            torch.sum(lin[:, None, None] * (na - nb) ** 2, dim=0))
    return total
