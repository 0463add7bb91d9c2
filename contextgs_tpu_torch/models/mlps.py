"""Decoder MLPs as `nn.Module`s (port of `contextgs_tpu/models/mlps.py`).

- opacity: Linear(feat+3+1 → feat) ReLU Linear(feat → K) Tanh
- cov:     Linear(feat+3+1 → feat) ReLU Linear(feat → 7K)
- color:   Linear(feat+3+1 → feat) ReLU Linear(feat → 3K) Sigmoid
- feature_bank (optional): Linear(3+1 → feat) ReLU Linear(feat → 3) Softmax
- grid[i]: Linear(in_i → 2·feat) ReLU Linear(2·feat → (feat+6+3K)·2+3), where
  in_i = hyper+3 for the coarsest level, context_dim+hyper otherwise. Carried
  for the context slice; the render path does not call them.

Init is U(±1/√fan_in) for weight and bias, as torch.nn.Linear's default,
drawn from an explicit `torch.Generator`. `nn.Linear.weight` is [out, in];
the reference's `Linear.w` is [in, out] (see convert.py). fp32 throughout.
"""

from __future__ import annotations

import torch
from torch import nn

from contextgs_tpu_torch.config import ModelConfig


def _linear(d_in: int, d_out: int, gen: torch.Generator | None) -> nn.Linear:
    lin = nn.Linear(d_in, d_out)
    bound = 1.0 / (d_in ** 0.5)
    with torch.no_grad():
        lin.weight.uniform_(-bound, bound, generator=gen)
        lin.bias.uniform_(-bound, bound, generator=gen)
    return lin


class MLP(nn.Module):
    """Linear → ReLU → Linear."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.l1 = _linear(d_in, d_hidden, gen)
        self.l2 = _linear(d_hidden, d_out, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.l2(torch.relu(self.l1(x)))


class DecoderMLPs(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None):
        super().__init__()
        f, k = cfg.feat_dim, cfg.n_offsets
        grid_out = (f + 6 + 3 * k) * 2 + 3
        self.opacity = MLP(f + 3 + 1, f, k, gen)
        self.cov = MLP(f + 3 + 1, f, 7 * k, gen)
        self.color = MLP(f + 3 + 1, f, 3 * k, gen)
        self.grid = nn.ModuleList(
            MLP(cfg.hyper_dim + 3 if i == cfg.level_num - 1
                else cfg.context_dim + cfg.hyper_dim, 2 * f, grid_out, gen)
            for i in range(cfg.level_num))
        self.feature_bank = MLP(3 + 1, f, 3, gen) if cfg.use_feat_bank else None


def init_decoder_mlps(cfg: ModelConfig, gen: torch.Generator | None = None,
                      device=None) -> DecoderMLPs:
    return DecoderMLPs(cfg, gen).to(device)


def apply_opacity(p: DecoderMLPs, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(p.opacity(x))


def apply_cov(p: DecoderMLPs, x: torch.Tensor) -> torch.Tensor:
    return p.cov(x)


def apply_color(p: DecoderMLPs, x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(p.color(x))


def apply_feature_bank(p: DecoderMLPs, x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(p.feature_bank(x), dim=1)
