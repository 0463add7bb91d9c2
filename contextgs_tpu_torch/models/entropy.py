"""Entropy models (port of `contextgs_tpu/models/entropy.py`): the
conditional-gaussian rate estimator, the Bernoulli mask rate, and the learned
factorized prior of the hyper latent (compressai's EntropyBottleneck with its
medians fixed at 0, forward only).

The prior's tensors live in a `FactorizedPrior` of tuples, named as the
reference's, so that its leaves are `prior.<field>.<i>` in
`state.param_leaves` and join the one Adam like every other parameter.
Everything runs in float32; the codec needs the same bits on both sides.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from contextgs_tpu_torch.models.quant import CLAMP_STEPS

LIKELIHOOD_BOUND = 1e-6
_LOG2 = math.log(2.0)


class _LowBound(torch.autograd.Function):
    """clamp(x, min=bound); the gradient passes where x ≥ bound or where it
    pushes x up (g < 0)."""

    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp(x, min=bound)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, 0.0), None


def low_bound(x: torch.Tensor, bound: float = LIKELIHOOD_BOUND):
    return _LowBound.apply(x, bound)


def _std_normal_cdf(x):
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def gaussian_bits(x: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor,
                  q, x_mean=None) -> torch.Tensor:
    """Per-element bits under N(mean, scale) integrated over the Q-bin: x
    clamped to x_mean ± 15000·Q (bounds detached), scale to ≥ 1e-9, the
    likelihood low-bounded at 1e-6."""
    if x_mean is not None:
        lo = (x_mean - CLAMP_STEPS * q).detach()
        hi = (x_mean + CLAMP_STEPS * q).detach()
        x = torch.minimum(torch.maximum(x, lo), hi)
    scale = torch.clamp(scale, min=1e-9)
    upper = _std_normal_cdf((x + 0.5 * q - mean) / scale)
    lower = _std_normal_cdf((x - 0.5 * q - mean) / scale)
    likelihood = low_bound(torch.abs(upper - lower))
    return -torch.log(likelihood) / _LOG2


def bernoulli_bits(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Bits of ±1 symbols under P(+1) = p."""
    p = torch.clamp(p, 1e-6, 1 - 1e-6)
    pos = (1 + x) / 2.0
    neg = (1 - x) / 2.0
    return (-torch.log(p) * pos - torch.log(1 - p) * neg) / _LOG2


def binary_grid_size_bits(mask: torch.Tensor, valid=None):
    """Ideal Bernoulli bit count of a {0,1} grid + 32 bits for the
    probability. Returns (p, total_bits)."""
    if valid is None:
        total = torch.tensor(mask.numel(), device=mask.device)
        pos = mask.sum()
    else:
        total = valid.sum()
        pos = (mask * valid).sum()
    p = torch.clamp(pos / torch.clamp(total, min=1), 1e-6, 1 - 1e-6)
    bits = (pos * (-torch.log(p)) / _LOG2
            + (total - pos) * (-torch.log(1 - p)) / _LOG2)
    return p, bits + 32.0


# ---------------------------------------------------------------------------
# Learned factorized prior (EntropyBottleneck replacement)
# ---------------------------------------------------------------------------

class FactorizedPrior(NamedTuple):
    """Per-channel monotone CDF network c(x) = sigmoid(g_K(...g_1(x)...)).

    matrices[i]: [C, f_{i+1}, f_i]; biases[i]: [C, f_{i+1}, 1];
    factors[i]: [C, f_{i+1}, 1] (none for the last layer).
    """

    matrices: tuple
    biases: tuple
    factors: tuple


def init_factorized_prior(channels: int,
                          generator: torch.Generator | None = None,
                          device=None, filters=(3, 3, 3, 3),
                          init_scale: float = 10.0) -> FactorizedPrior:
    """compressai's EntropyBottleneck init: matrices filled with
    log(expm1(1/scale/f)), biases U(-0.5, 0.5) from `generator` (a CPU
    generator, layer by layer), factors zero."""
    dims = (1,) + tuple(filters) + (1,)
    scale = init_scale ** (1.0 / (len(filters) + 1))
    matrices, biases, factors = [], [], []
    for i in range(len(filters) + 1):
        init = math.log(math.expm1(1.0 / scale / dims[i + 1]))
        shape = (channels, dims[i + 1], 1)
        matrices.append(torch.full((channels, dims[i + 1], dims[i]), init,
                                   dtype=torch.float32, device=device))
        biases.append((torch.rand(shape, generator=generator,
                                  dtype=torch.float32) - 0.5).to(device))
        if i < len(filters):
            factors.append(torch.zeros(shape, dtype=torch.float32,
                                       device=device))
    return FactorizedPrior(tuple(matrices), tuple(biases), tuple(factors))


def _logits_cumulative(prior: FactorizedPrior,
                       x: torch.Tensor) -> torch.Tensor:
    """x [C, 1, N] → logits [C, 1, N]. Each layer is at most 3 wide, so
    its product is a broadcast multiply summed over the layer's inputs,
    not a bmm: a bmm's weight gradient is a reduction over all N columns,
    which cuBLAS runs as a slow GEMV-like kernel at N = 400k."""
    logits = x
    for i in range(len(prior.matrices)):
        m = F.softplus(prior.matrices[i])              # [C, f_out, f_in]
        logits = ((m[..., None] * logits[:, None]).sum(2)
                  + prior.biases[i])
        if i < len(prior.factors):
            logits = logits + torch.tanh(prior.factors[i]) * torch.tanh(logits)
    return logits


def _bin_probability(prior: FactorizedPrior, xt: torch.Tensor,
                     detach_sign: bool) -> torch.Tensor:
    """|c(x + ½) − c(x − ½)| [C, 1, N], with the sign trick for
    numerical stability."""
    lower = _logits_cumulative(prior, xt - 0.5)
    upper = _logits_cumulative(prior, xt + 0.5)
    sign = -torch.sign(lower + upper)
    if detach_sign:
        sign = sign.detach()
    return torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))


def factorized_likelihood(prior: FactorizedPrior,
                          x: torch.Tensor) -> torch.Tensor:
    """Likelihood of x [N, C] under the prior (Q = 1 bins) → [N, C]."""
    likelihood = _bin_probability(prior, x.t()[:, None, :], True)
    return low_bound(likelihood[:, 0, :].t())


def factorized_forward(prior: FactorizedPrior, x: torch.Tensor,
                       u: torch.Tensor | None, training: bool):
    """(noisy or rounded latent, its likelihood). Training adds the noise
    u − ½, u being U[0,1) draws of x's shape (`context.context_draws`
    makes them); eval rounds with a straight-through gradient."""
    if training:
        y = x + (u - 0.5)
    else:
        y = x + (torch.round(x) - x).detach()
    return y, factorized_likelihood(prior, y)


def factorized_pmf_table(prior: FactorizedPrior, min_sym: int,
                         max_sym: int) -> torch.Tensor:
    """PMF of each integer symbol in [min_sym, max_sym] per channel → [C, S],
    the codec's CDF tables."""
    c = prior.matrices[0].shape[0]
    grid = torch.arange(min_sym, max_sym + 1, dtype=torch.float32,
                        device=prior.matrices[0].device)
    xt = grid[None, None, :].expand(c, 1, grid.shape[0])
    return _bin_probability(prior, xt, False)[:, 0, :]
