"""Neural gaussian decode: anchors + MLPs → per-gaussian attributes (port of
`contextgs_tpu/models/decode.py`).

The view-conditioned Scaffold-GS decode. As in the reference, the
gaussian slots of every anchor decoded are returned and culled ones carry
opacity 0 (the rasterizer's 1/255 rule skips them); the renderers decode only
the visible anchors (`anchor_index`), as the CUDA reference does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from contextgs_tpu_torch.config import ModelConfig, OptimizationConfig
from contextgs_tpu_torch.models import context, state as st
from contextgs_tpu_torch.models.levels import LevelMaps
from contextgs_tpu_torch.models.mlps import (apply_color, apply_cov,
                                             apply_feature_bank, apply_opacity)
from contextgs_tpu_torch.models.quant import uniform_noise_quant
from contextgs_tpu_torch.utils import trace


class NeuralGaussians(NamedTuple):
    """[N·K] gaussian attributes (dead slots have opacity 0)."""

    xyz: torch.Tensor            # [NK,3]
    color: torch.Tensor          # [NK,3]
    opacity: torch.Tensor        # [NK]
    scaling: torch.Tensor        # [NK,3]
    rot: torch.Tensor            # [NK,4]
    neural_opacity: torch.Tensor  # [NK] pre-mask opacity (densification stats)
    gauss_valid: torch.Tensor    # [NK] bool — opacity>0, mask on, anchor visible
    anchor_visible: torch.Tensor  # [N] bool


class DecodeAux(NamedTuple):
    rate: context.RateSummary | None
    context: context.ContextOutput | None


def decode_neural_gaussians(
    params,                           # needs `.mlps`
    buffers: st.Buffers | None,
    cfg: ModelConfig,
    camera_center: torch.Tensor,      # [3]
    visible_mask: torch.Tensor,       # [N] bool (prefilter result ∧ alive)
    *,
    feat: torch.Tensor,               # [N,F]
    grid_scaling: torch.Tensor,       # [N,6]
    grid_offsets: torch.Tensor,       # [N,K,3]
    anchor: torch.Tensor,             # [N,3] quantized anchors
    binary_mask: torch.Tensor | None = None,  # [N,K] override (decoded scenes)
) -> NeuralGaussians:
    """The Scaffold-GS decode."""
    n, k = grid_offsets.shape[0], cfg.n_offsets

    ob_view = anchor - camera_center[None]
    ob_dist = torch.linalg.norm(ob_view, dim=1, keepdim=True)
    ob_view = ob_view / torch.clamp(ob_dist, min=1e-12)

    if cfg.use_feat_bank and params.mlps.feature_bank is not None:
        # view-weighted blend of [coarse ::4, mid ::2, full] channel
        # subsamplings, each tiled back to full width (jnp.tile → repeat)
        bank_w = apply_feature_bank(params.mlps,
                                    torch.cat([ob_view, ob_dist], dim=1))
        c = feat.shape[1]
        f4 = feat[:, ::4].repeat(1, 4)[:, :c]
        f2 = feat[:, ::2].repeat(1, 2)[:, :c]
        feat = (f4 * bank_w[:, 0:1] + f2 * bank_w[:, 1:2]
                + feat * bank_w[:, 2:3])

    cat_view = torch.cat([feat, ob_view, ob_dist], dim=1)          # [N,F+4]

    neural_opacity = apply_opacity(params.mlps, cat_view).reshape(n * k)
    if binary_mask is None:
        binary_mask = st.get_mask(params)
    neural_opacity = neural_opacity * binary_mask.reshape(n * k)
    pos_mask = neural_opacity > 0.0

    color = apply_color(params.mlps, cat_view).reshape(n * k, 3)
    scale_rot = apply_cov(params.mlps, cat_view).reshape(n * k, 7)

    scaling_rep = torch.repeat_interleave(grid_scaling, k, dim=0)  # [NK,6]
    anchor_rep = torch.repeat_interleave(anchor, k, dim=0)         # [NK,3]
    offsets = grid_offsets.reshape(n * k, 3)

    scaling = scaling_rep[:, 3:] * torch.sigmoid(scale_rot[:, :3])
    rot_raw = scale_rot[:, 3:7]
    rot = rot_raw / torch.clamp(
        torch.linalg.norm(rot_raw, dim=1, keepdim=True), min=1e-12)
    xyz = anchor_rep + offsets * scaling_rep[:, :3]

    valid = pos_mask & torch.repeat_interleave(visible_mask, k, dim=0)
    opacity = torch.where(valid, neural_opacity, 0.0)

    return NeuralGaussians(xyz=xyz, color=color, opacity=opacity,
                           scaling=scaling, rot=rot,
                           neural_opacity=neural_opacity,
                           gauss_valid=valid, anchor_visible=visible_mask)


class PhaseInputs(NamedTuple):
    """What a training phase decodes, for all N anchors."""

    anchor_q: torch.Tensor       # [N,3] quantized anchors
    feat: torch.Tensor           # [N,F]
    grid_scaling: torch.Tensor   # [N,6]
    grid_offsets: torch.Tensor   # [N,K,3]
    aux: DecodeAux


def phase_inputs(
    params: st.Params,
    buffers: st.Buffers,
    cfg: ModelConfig,
    opt: OptimizationConfig,
    generator: torch.Generator | None = None,
    *,
    phase: str,                       # "plain" | "noise" | "context"
    training: bool,
    maps: LevelMaps | None = None,    # required for phase="context"
    draws: context.ContextDraws | None = None,
) -> PhaseInputs:
    """The anchors' features, scalings and offsets as `phase` decodes them.

    phase="plain": raw parameters (step ≤ 3000, or a decoded-version eval);
    phase="noise": uniform noise at base Q on feat, grid scaling and offsets,
    drawn from `generator` in that order over all N anchors, whether or not
    `training` is set (the reference does the same); phase="context": the
    multi-level context quantization over all N anchors (`maps` gives the
    levels), noise of the predicted Q from `draws` (by default
    `context.context_draws` of `generator`) and the rate estimate in the
    aux when training, STE rounding and no draws otherwise. The noise and
    context phases count their N rows into the trace counter
    `context_rows`."""
    if phase not in ("plain", "noise", "context"):
        raise ValueError(f"unknown phase {phase!r}")
    anchor_q = st.get_anchor(params, buffers)
    feat = params.anchor_feat
    grid_scaling = st.get_scaling(params)
    grid_offsets = params.offsets
    aux = DecodeAux(rate=None, context=None)
    if phase != "plain":
        trace.count("context_rows", anchor_q.shape[0])
    if phase == "noise":
        feat = uniform_noise_quant(feat, cfg.q_feat, generator)
        grid_scaling = uniform_noise_quant(grid_scaling, cfg.q_scaling,
                                           generator)
        grid_offsets = uniform_noise_quant(grid_offsets, cfg.q_offsets,
                                           generator)
    elif phase == "context":
        if maps is None:
            raise ValueError('phase="context" needs the level maps')
        n = anchor_q.shape[0]
        if draws is None:
            # looked up on the module, so that a test can hand in its draws
            draws = context.context_draws(generator, n, cfg, training,
                                          anchor_q.device)
        with trace.span("context/quantize"):
            ctx = context.multi_scale_generate(
                params, buffers, cfg, maps, anchor_q, draws, training,
                disable_hyper=opt.disable_hyper)
        feat, grid_scaling, grid_offsets = (ctx.feat_q, ctx.scaling_q,
                                            ctx.offsets_q)
        rate = None
        if training:
            with trace.span("context/rate"):
                rate = context.estimate_rate(
                    params, buffers, cfg, ctx, st.get_mask(params),
                    st.get_mask_anchor(params, buffers.alive), draws.rate,
                    sample_frac=opt.rate_sample_frac)
        aux = DecodeAux(rate=rate, context=ctx)
    return PhaseInputs(anchor_q, feat, grid_scaling, grid_offsets, aux)


def generate_neural_gaussians(
    params: st.Params,
    buffers: st.Buffers,
    cfg: ModelConfig,
    opt: OptimizationConfig,
    camera_center: torch.Tensor,
    visible_mask: torch.Tensor,       # [N] bool from prefilter (∧ alive)
    generator: torch.Generator | None = None,
    *,
    phase: str,                       # "plain" | "noise" | "context"
    training: bool,
    anchor_index: torch.Tensor | None = None,
    maps: LevelMaps | None = None,    # required for phase="context"
    inputs: PhaseInputs | None = None,
) -> tuple[NeuralGaussians, DecodeAux]:
    """Training-schedule switchyard: `phase_inputs` (or the `inputs` it
    gave), then the decode. Noise and context cover all N anchors, so they
    do not depend on the view. With `anchor_index`, only those anchors are
    decoded and the result covers their len(anchor_index)·K slots."""
    if inputs is None:
        inputs = phase_inputs(params, buffers, cfg, opt, generator,
                              phase=phase, training=training, maps=maps)
    anchor_q, feat, grid_scaling, grid_offsets, aux = inputs
    binary_mask = st.get_mask(params)
    if anchor_index is not None:
        feat, grid_scaling, grid_offsets, anchor_q, binary_mask, \
            visible_mask = (x[anchor_index] for x in (
                feat, grid_scaling, grid_offsets, anchor_q, binary_mask,
                visible_mask))
    ng = decode_neural_gaussians(
        params, buffers, cfg, camera_center, visible_mask, feat=feat,
        grid_scaling=grid_scaling, grid_offsets=grid_offsets, anchor=anchor_q,
        binary_mask=binary_mask)
    return ng, aux
