"""Optimizer: one hand-written Adam with per-group log-lerp learning-rate
schedules (port of `contextgs_tpu/train/optim.py`).

Not `torch.optim.Adam`: the moments are plain tensors aligned with the padded
anchor pool, so densification zeroes the rows of the slots it activates
(`models/densify.py`), and the update matches the reference's arithmetic
(eps 1e-15, bias-corrected, one lr per group). The learning rates are Python
floats computed on the host from the step number, so no schedule value
reaches the card.

Groups with schedules: offset, mask, mlp_opacity, mlp_cov, mlp_color,
latent_codec (prior), mlp_grid, mlp_featurebank (and anchor, whose lr is 0:
anchors are frozen). Constant lr: anchor_feat, hyper_latent, opacity,
scaling. Rotation and opacity_raw are frozen (lr 0).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from contextgs_tpu_torch.config import OptimizationConfig
from contextgs_tpu_torch.models.state import Params, param_leaves


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 30_000,
             step_sub: int = 0) -> float:
    """Log-lerp schedule of the reference (`utils/general_utils.py`)."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
    else:
        delay = 1.0
    t = min(max((step - step_sub) / (max_steps - step_sub), 0.0), 1.0)
    log_lerp = math.exp(math.log(max(lr_init, 1e-30)) * (1 - t)
                        + math.log(max(lr_final, 1e-30)) * t)
    return delay * log_lerp


def group_lrs(opt: OptimizationConfig, step,
              spatial_lr_scale: float) -> dict:
    """Learning rate of every group at `step`."""
    s = spatial_lr_scale
    return dict(
        anchor=expon_lr(step, opt.anchor_lr * s, 0.0),
        offset=expon_lr(step, opt.offset_lr_init * s, opt.offset_lr_final * s,
                        lr_delay_mult=opt.offset_lr_delay_mult,
                        max_steps=opt.offset_lr_max_steps),
        mask_logit=expon_lr(step, opt.mask_lr_init * s, opt.mask_lr_final * s,
                            lr_delay_mult=opt.mask_lr_delay_mult,
                            max_steps=opt.mask_lr_max_steps),
        anchor_feat=opt.feature_lr,
        hyper_latent=opt.hyper_latent_lr,
        opacity_raw=opt.opacity_lr,
        scaling_log=opt.scaling_lr,
        rotation=opt.rotation_lr,
        mlp_opacity=expon_lr(step, opt.mlp_opacity_lr_init,
                             opt.mlp_opacity_lr_final,
                             lr_delay_mult=opt.mlp_opacity_lr_delay_mult,
                             max_steps=opt.mlp_opacity_lr_max_steps),
        mlp_cov=expon_lr(step, opt.mlp_cov_lr_init, opt.mlp_cov_lr_final,
                         lr_delay_mult=opt.mlp_cov_lr_delay_mult,
                         max_steps=opt.mlp_cov_lr_max_steps),
        mlp_color=expon_lr(step, opt.mlp_color_lr_init, opt.mlp_color_lr_final,
                           lr_delay_mult=opt.mlp_color_lr_delay_mult,
                           max_steps=opt.mlp_color_lr_max_steps),
        mlp_featurebank=expon_lr(step, opt.mlp_featurebank_lr_init,
                                 opt.mlp_featurebank_lr_final,
                                 lr_delay_mult=opt.mlp_featurebank_lr_delay_mult,
                                 max_steps=opt.mlp_featurebank_lr_max_steps),
        latent_codec=expon_lr(step, opt.latent_codec_lr_init,
                              opt.latent_codec_lr_final,
                              lr_delay_mult=opt.latent_codec_lr_delay_mult,
                              max_steps=opt.latent_codec_lr_max_steps),
        mlp_grid=expon_lr(step, opt.mlp_grid_lr_init, opt.mlp_grid_lr_final,
                          lr_delay_mult=opt.mlp_grid_lr_delay_mult,
                          max_steps=opt.mlp_grid_lr_max_steps),
    )


_MLP_GROUPS = {"opacity": "mlp_opacity", "cov": "mlp_cov",
               "color": "mlp_color", "grid": "mlp_grid",
               "feature_bank": "mlp_featurebank"}
_FROZEN = ("rotation", "opacity_raw")


def leaf_lr(name: str, lrs: dict) -> float:
    """The lr of the leaf `name` (a key of `state.param_leaves`)."""
    if name in _FROZEN:
        return 0.0
    if name.startswith("mlps."):
        return lrs[_MLP_GROUPS[name.split(".")[1]]]
    if name.startswith("prior."):
        return lrs["latent_codec"]
    return lrs["offset" if name == "offsets" else name]


class AdamState(NamedTuple):
    mu: dict        # leaf name → first moment, as `state.param_leaves`
    nu: dict        # leaf name → second moment
    count: int


def init_adam(params: Params) -> AdamState:
    zeros = {name: torch.zeros_like(x)
             for name, x in param_leaves(params).items()}
    return AdamState(mu=zeros,
                     nu={name: torch.zeros_like(x) for name, x in
                         zeros.items()},
                     count=0)


@torch.no_grad()
def adam_update(params: Params, grads: dict, state: AdamState,
                opt: OptimizationConfig, step, spatial_lr_scale: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15
                ) -> tuple[Params, AdamState]:
    """Adam(eps=1e-15) with each leaf's lr from the schedule, torch.optim.Adam
    semantics (bias-corrected step size). `grads` maps leaf names to
    gradients; a leaf with none (unused in this phase) is updated with a
    zero gradient, as the reference updates it. Parameters and moments are
    updated in place, which saves a copy of the model; the same `params`
    is returned with a new AdamState."""
    lrs = group_lrs(opt, step, spatial_lr_scale)
    count = state.count + 1
    cf = torch.tensor(float(count), dtype=torch.float32)
    bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** cf)
    bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** cf)
    for name, p in param_leaves(params).items():
        g = grads.get(name)
        if g is None:
            g = torch.zeros_like(p)
        m, v = state.mu[name], state.nu[name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * (g * g))
        p.sub_(leaf_lr(name, lrs) * (m / bc1)
               / (torch.sqrt(v / bc2) + eps))
    return params, AdamState(mu=state.mu, nu=state.nu, count=count)
