"""Neural gaussian decode: anchors + MLPs → per-gaussian attributes (port of
`contextgs_tpu/models/decode.py`).

The view-conditioned Scaffold-GS decode. As in the reference, all N·K
gaussian slots are returned and culled ones carry opacity 0 (the rasterizer's
1/255 rule skips them); the decoded-scene renderer compacts the visible
anchors first, as the CUDA reference does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from contextgs_tpu_torch.config import ModelConfig, OptimizationConfig
from contextgs_tpu_torch.models import state as st
from contextgs_tpu_torch.models.mlps import (apply_color, apply_cov,
                                             apply_feature_bank, apply_opacity)


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
    rate: object | None
    context: object | None


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


def generate_neural_gaussians(
    params: st.Params,
    buffers: st.Buffers,
    cfg: ModelConfig,
    opt: OptimizationConfig,
    camera_center: torch.Tensor,
    visible_mask: torch.Tensor,       # [N] bool from prefilter (∧ alive)
    generator: torch.Generator | None = None,
    *,
    phase: str,                       # "plain" (ported) | "noise" | "context"
    training: bool,
) -> tuple[NeuralGaussians, DecodeAux]:
    """Training-schedule switchyard; this slice ports phase="plain" (raw
    parameters: steps ≤ 3000, or a decoded-version eval)."""
    if phase == "noise":
        raise NotImplementedError(
            'phase="noise" comes with the training slice '
            "(ROADMAP.md queue 1, slice 2)")
    if phase == "context":
        raise NotImplementedError(
            'phase="context" comes with the context and entropy slice '
            "(ROADMAP.md queue 1, slice 3)")
    if phase != "plain":
        raise ValueError(f"unknown phase {phase!r}")
    ng = decode_neural_gaussians(
        params, buffers, cfg, camera_center, visible_mask,
        feat=params.anchor_feat, grid_scaling=st.get_scaling(params),
        grid_offsets=params.offsets, anchor=st.get_anchor(params, buffers))
    return ng, DecodeAux(rate=None, context=None)
