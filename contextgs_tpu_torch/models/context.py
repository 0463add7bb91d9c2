"""Autoregressive multi-level context (port of
`contextgs_tpu/models/context.py`), the core of ContextGS.

Levels run coarsest to finest. Each anchor is quantized once, at its own
level, with entropy parameters (μ, σ, Q) that the level's grid MLP predicts
from the already-coded parent at the next coarser level; the coarsest level
is conditioned on the anchor position and the hyper latent only.

The reference runs every level's MLP over the whole padded pool and merges
rows with `where(level == i ∧ alive)`, which keeps its shapes static. The
port runs each level only on its members and writes their rows into the
pool (`index_copy`): the MLP is row-wise, so the values are the same, and
the other rows get the same zeros and no gradient, while the MLPs see the
alive anchors once instead of the whole pool three times.

Every random number of the phase comes from `context_draws`, in one fixed
order, so a test can hand the port the reference's draws.

Precision: the grid MLPs and the entropy math run in float32 on the card.
The port never turns on `torch.backends.cuda.matmul.allow_tf32`: the codec's
encoder and decoder must compute bit-identical μ, σ and Q, both through
`make_level_predictor`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from contextgs_tpu_torch.config import ModelConfig
from contextgs_tpu_torch.models import state as st
from contextgs_tpu_torch.models.entropy import (binary_grid_size_bits,
                                                factorized_forward,
                                                gaussian_bits)
from contextgs_tpu_torch.models.levels import LevelMaps
from contextgs_tpu_torch.models.mlps import apply_grid
from contextgs_tpu_torch.models.quant import ste_multistep
from contextgs_tpu_torch.utils import trace


class EntropyParams(NamedTuple):
    """Per-anchor predicted entropy parameters over the pool."""

    mean_feat: torch.Tensor      # [N,F]
    scale_feat: torch.Tensor     # [N,F]
    q_feat: torch.Tensor         # [N,1]
    mean_scaling: torch.Tensor   # [N,6]
    scale_scaling: torch.Tensor  # [N,6]
    q_scaling: torch.Tensor      # [N,1]
    mean_offsets: torch.Tensor   # [N,3K]
    scale_offsets: torch.Tensor  # [N,3K]
    q_offsets: torch.Tensor      # [N,1]


class ContextOutput(NamedTuple):
    feat_q: torch.Tensor         # [N,F] dequantized features
    scaling_q: torch.Tensor      # [N,6]
    offsets_q: torch.Tensor      # [N,K,3]
    hyper_q: torch.Tensor        # [N,Fh] noisy or rounded hyper latent
    eparams: EntropyParams
    likelihood_hyper: torch.Tensor  # [N,Fh]


class RateSummary(NamedTuple):
    bit_per_param: torch.Tensor
    bit_per_feat_param: torch.Tensor
    bit_per_scaling_param: torch.Tensor
    bit_per_offsets_param: torch.Tensor
    bit_per_hyper_param: torch.Tensor
    bit_per_anchor_param: torch.Tensor


class ContextDraws(NamedTuple):
    """U[0,1) draws of one training step of the context phase."""

    hyper: torch.Tensor          # [N,Fh] hyper-latent noise
    feat: tuple                  # per level i: [N,F]
    scaling: tuple               # per level i: [N,6]
    offsets: tuple               # per level i: [N,3K]
    rate: torch.Tensor           # [N] rate subsample


def context_draws(generator: torch.Generator | None, n: int,
                  cfg: ModelConfig, training: bool,
                  device=None) -> ContextDraws | None:
    """Every random number of the context phase for a pool of n slots, drawn
    from `generator` on `device` in this order: the hyper noise, then per
    level from the coarsest the feat, scaling and offset noise, then the
    rate subsample. Eval quantizes by rounding and draws nothing (None)."""
    if not training:
        return None

    def u(*shape):
        return torch.rand(shape, generator=generator, dtype=torch.float32,
                          device=device)

    hyper = u(n, cfg.hyper_dim)
    per_level = {}
    for i in reversed(range(cfg.level_num)):
        per_level[i] = (u(n, cfg.feat_dim), u(n, 6), u(n, 3 * cfg.n_offsets))
    levels = [per_level[i] for i in range(cfg.level_num)]
    return ContextDraws(hyper=hyper, feat=tuple(x[0] for x in levels),
                        scaling=tuple(x[1] for x in levels),
                        offsets=tuple(x[2] for x in levels), rate=u(n))


def predict_entropy_params(mlps, level: int, feat_in: torch.Tensor,
                           cfg: ModelConfig) -> EntropyParams:
    """Run grid MLP `level` and split μ, σ and Q."""
    f, k = cfg.feat_dim, cfg.n_offsets
    pred = apply_grid(mlps, level, feat_in)
    parts = torch.split(pred, [f, f, 6, 6, 3 * k, 3 * k, 1, 1, 1], dim=1)
    (mean_feat, scale_feat, mean_scaling, scale_scaling,
     mean_offsets, scale_offsets, qf, qs, qo) = parts
    q_feat = torch.clamp(cfg.q_feat * (1 + torch.tanh(qf)), min=1e-9)
    q_scaling = torch.clamp(cfg.q_scaling * (1 + torch.tanh(qs)), min=1e-9)
    q_offsets = torch.clamp(cfg.q_offsets * (1 + torch.tanh(qo)), min=1e-9)
    return EntropyParams(mean_feat, scale_feat, q_feat,
                         mean_scaling, scale_scaling, q_scaling,
                         mean_offsets, scale_offsets, q_offsets)


def _level_input(level: int, cfg: ModelConfig, anchor_q, feat_state,
                 scaling_state, parent, hyper_ctx,
                 rows: torch.Tensor | None = None) -> torch.Tensor:
    """The grid MLP's input for `rows` (all when None): anchor and hyper
    latent at the coarsest level, else the parent's anchor, coded feature
    and scaling, and the hyper latent."""
    def own(x):
        return x if rows is None else torch.index_select(x, 0, rows)

    if level == cfg.level_num - 1:
        return torch.cat([own(anchor_q), own(hyper_ctx)], dim=1)
    p = own(parent).long()
    return torch.cat([torch.index_select(x, 0, p)
                      for x in (anchor_q, feat_state, scaling_state)]
                     + [own(hyper_ctx)], dim=1)


def make_level_predictor(cfg: ModelConfig):
    """The per-level entropy-parameter predictor that the codec's encoder
    and decoder share: one function, so both sides compute the same μ, σ
    and Q. `predict(mlps, level, anchor_q, feat_state, scaling_state,
    parent, hyper_ctx) -> EntropyParams`."""

    def predict(mlps, level: int, anchor_q, feat_state, scaling_state,
                parent, hyper_ctx) -> EntropyParams:
        return predict_entropy_params(
            mlps, level, _level_input(level, cfg, anchor_q, feat_state,
                                      scaling_state, parent, hyper_ctx), cfg)

    return predict


def multi_scale_generate(params: st.Params, buffers: st.Buffers,
                         cfg: ModelConfig, maps: LevelMaps,
                         anchor_q: torch.Tensor, draws: ContextDraws | None,
                         training: bool, disable_hyper: bool = False
                         ) -> ContextOutput:
    """Quantize feat, scaling and offsets of every anchor through the
    level-wise context: noise of the predicted Q from `draws` when
    training, STE rounding (detached) otherwise."""
    n = anchor_q.shape[0]
    f, k_off = cfg.feat_dim, cfg.n_offsets
    hyper_q, lik_hyper = factorized_forward(
        params.prior, params.hyper_latent,
        draws.hyper if training else None, training)
    hyper_ctx = hyper_q * 0.0 if disable_hyper else hyper_q

    feat_q = torch.zeros_like(params.anchor_feat)
    scaling_q = torch.zeros_like(params.scaling_log)
    offsets_flat = params.offsets.reshape(n, 3 * k_off)
    offsets_q = torch.zeros_like(offsets_flat)

    def full(width, value):
        return torch.full((n, width), value, dtype=torch.float32,
                          device=anchor_q.device)

    ep = EntropyParams(
        mean_feat=full(f, 0.0), scale_feat=full(f, 0.0), q_feat=full(1, 1.0),
        mean_scaling=full(6, 0.0), scale_scaling=full(6, 0.0),
        q_scaling=full(1, 1.0), mean_offsets=full(3 * k_off, 0.0),
        scale_offsets=full(3 * k_off, 0.0), q_offsets=full(1, 1.0))
    grid_scaling = st.get_scaling(params)

    for i in reversed(range(cfg.level_num)):
        with trace.sync("context.level"):
            rows = torch.nonzero((maps.level == i)
                                 & buffers.alive).squeeze(1)

        def own(x):
            return torch.index_select(x, 0, rows)

        lep = predict_entropy_params(
            params.mlps, i, _level_input(i, cfg, anchor_q, feat_q, scaling_q,
                                         maps.parent, hyper_ctx, rows), cfg)
        x_feat, x_scaling, x_off = (own(params.anchor_feat),
                                    own(grid_scaling), own(offsets_flat))
        if training:
            new_feat = x_feat + (own(draws.feat[i]) - 0.5) * lep.q_feat
            new_scaling = (x_scaling
                           + (own(draws.scaling[i]) - 0.5) * lep.q_scaling)
            new_offsets = x_off + (own(draws.offsets[i]) - 0.5) * lep.q_offsets
        else:
            new_feat = ste_multistep(x_feat, lep.q_feat).detach()
            new_scaling = ste_multistep(x_scaling, lep.q_scaling).detach()
            new_offsets = ste_multistep(x_off, lep.q_offsets).detach()
        feat_q = feat_q.index_copy(0, rows, new_feat)
        scaling_q = scaling_q.index_copy(0, rows, new_scaling)
        offsets_q = offsets_q.index_copy(0, rows, new_offsets)
        ep = EntropyParams(*(b.index_copy(0, rows, a)
                             for a, b in zip(lep, ep)))

    return ContextOutput(feat_q=feat_q, scaling_q=scaling_q,
                         offsets_q=offsets_q.reshape(n, k_off, 3),
                         hyper_q=hyper_q, eparams=ep,
                         likelihood_hyper=lik_hyper)


def estimate_total_bits(params: st.Params, buffers: st.Buffers,
                        cfg: ModelConfig, maps: LevelMaps, anchor_q,
                        disable_hyper: bool = False) -> dict:
    """Model estimate of the final bitstream size in bits per stream: the
    eval-mode rate summed over the kept anchors, anchors at 16 bits a
    coordinate, masks at their ideal Bernoulli count."""
    out = multi_scale_generate(params, buffers, cfg, maps, anchor_q, None,
                               training=False, disable_hyper=disable_hyper)
    mask_anchor = st.get_mask_anchor(params, buffers.alive)
    cm = mask_anchor[:, None].to(torch.float32)
    ep = out.eparams
    n = anchor_q.shape[0]
    bit_hyper = (-torch.log2(out.likelihood_hyper) * cm).sum()
    bit_feat = (gaussian_bits(out.feat_q, ep.mean_feat, ep.scale_feat,
                              ep.q_feat) * cm).sum()
    bit_scaling = (gaussian_bits(out.scaling_q, ep.mean_scaling,
                                 ep.scale_scaling, ep.q_scaling) * cm).sum()
    off = out.offsets_q.reshape(n, -1)
    masks = st.get_mask(params)
    m3 = torch.repeat_interleave(masks, 3, dim=-1).reshape(n, -1)
    bit_offsets = (gaussian_bits(off, ep.mean_offsets, ep.scale_offsets,
                                 ep.q_offsets) * m3 * cm).sum()
    n_keep = mask_anchor.sum()
    _, bit_masks = binary_grid_size_bits(
        masks, valid=mask_anchor[:, None].expand(masks.shape))
    return dict(anchor=n_keep * 3 * 16, hyper=bit_hyper, feat=bit_feat,
                scaling=bit_scaling, offsets=bit_offsets, masks=bit_masks)


def estimate_rate(params: st.Params, buffers: st.Buffers, cfg: ModelConfig,
                  out: ContextOutput, binary_masks: torch.Tensor,
                  mask_anchor: torch.Tensor, u: torch.Tensor,
                  sample_frac: float = 0.15) -> RateSummary:
    """Monte-Carlo rate estimate over the kept anchors with u ≤ sample_frac
    (u: the [N] U[0,1) rate draws of `context_draws`)."""
    n = out.feat_q.shape[0]
    f, k_off = cfg.feat_dim, cfg.n_offsets
    choose = (u <= sample_frac) & mask_anchor
    cm = choose[:, None].to(torch.float32)
    n_chosen = torch.clamp(choose.sum(), min=1).to(torch.float32)
    alive_f = buffers.alive.to(torch.float32)
    n_aliv = torch.clamp(alive_f.sum(), min=1)
    mask_anchor_rate = mask_anchor.sum() / n_aliv

    def masked_mean(x, m):
        return (x * m[:, None]).sum() / torch.clamp(m.sum() * x.shape[1],
                                                    min=1)

    ep = out.eparams
    x_mean_feat = masked_mean(params.anchor_feat, alive_f)
    x_mean_scaling = masked_mean(st.get_scaling(params), alive_f)
    x_mean_off = masked_mean(params.offsets.reshape(n, -1), alive_f)

    bit_hyper = -torch.log2(out.likelihood_hyper) * cm
    bit_feat = gaussian_bits(out.feat_q, ep.mean_feat, ep.scale_feat,
                             ep.q_feat, x_mean_feat) * cm
    bit_scaling = gaussian_bits(out.scaling_q, ep.mean_scaling,
                                ep.scale_scaling, ep.q_scaling,
                                x_mean_scaling) * cm
    off_flat = out.offsets_q.reshape(n, 3 * k_off)
    mask3 = torch.repeat_interleave(binary_masks, 3, dim=-1).reshape(
        n, 3 * k_off)
    bit_offsets = gaussian_bits(off_flat, ep.mean_offsets, ep.scale_offsets,
                                ep.q_offsets, x_mean_off) * mask3 * cm

    n_feat = n_chosen * f
    n_scaling = n_chosen * 6
    n_off = n_chosen * 3 * k_off
    n_hyper = n_chosen * cfg.hyper_dim
    s_hyper, s_feat = bit_hyper.sum(), bit_feat.sum()
    s_scaling, s_off = bit_scaling.sum(), bit_offsets.sum()
    return RateSummary(
        bit_per_param=(s_feat + s_scaling + s_off + s_hyper)
        / (n_feat + n_scaling + n_off) * mask_anchor_rate,
        bit_per_feat_param=s_feat / n_feat * mask_anchor_rate,
        bit_per_scaling_param=s_scaling / n_scaling * mask_anchor_rate,
        bit_per_offsets_param=s_off / n_off * mask_anchor_rate,
        bit_per_hyper_param=s_hyper / n_hyper * mask_anchor_rate,
        bit_per_anchor_param=16.0 * mask_anchor_rate,
    )
