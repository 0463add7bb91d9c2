"""Training step: render → loss → gradients → Adam → densification statistics
(port of `contextgs_tpu/train/step.py`).

loss = lmbda_rec·((1−λ_ssim)·L1 + λ_ssim·(1−SSIM)) + scaling_reg_weight·Π̄scaling
over the valid gaussians, plus λ·bit_per_param + mask_reg_weight·mean σ(mask)
over the alive anchors in the context phase. The context phase builds its
level maps over the kept set (alive ∧ mask_anchor), as the encoder does, from
the detached quantized anchors. The densification statistics come from the
gradient of a zero `screen_dummy` added to the projected means, as in the
reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from contextgs_tpu_torch.config import ModelConfig, TrainConfig
from contextgs_tpu_torch.models import densify, state as st
from contextgs_tpu_torch.models.levels import LevelMaps, build_level_maps
from contextgs_tpu_torch.models.renderer import render
from contextgs_tpu_torch.models.state import ANCHOR_FIELDS, Buffers, Params
from contextgs_tpu_torch.ops.ssim import l1_loss, psnr, ssim
from contextgs_tpu_torch.train.optim import AdamState, adam_update
from contextgs_tpu_torch.utils import trace

PHASES = ("plain", "noise", "context")


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    psnr: torch.Tensor
    bit_per_param: torch.Tensor
    n_visible_gauss: torch.Tensor
    overflowed: bool             # always False: instance lists are dynamic
    vis_overflowed: bool         # always False: no visible-gaussian cap
    n_instances: int             # tile-instance count
    n_vis: torch.Tensor          # gaussians touching >= 1 tile


def _check_phase(phase: str, mcfg: ModelConfig, level_scales) -> None:
    if phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r}")
    if phase == "context" and len(level_scales) != mcfg.level_num - 1:
        raise ValueError(f'phase="context" needs {mcfg.level_num - 1} level '
                         f"scales, got {list(level_scales)}")


def kept_level_maps(params: Params, buffers: Buffers, mcfg: ModelConfig,
                    voxel_size: float, level_scales) -> LevelMaps:
    """Level maps over the kept set (alive ∧ mask_anchor) of the detached
    quantized anchors."""
    return build_level_maps(
        st.get_anchor(params, buffers).detach(),
        st.get_mask_anchor(params, buffers.alive), voxel_size,
        level_scales, mcfg.level_num)


def _grad_leaves(params: Params):
    """(params whose anchor fields and prior are fresh leaves that require
    grad, {leaf name: tensor autograd differentiates}, in the order of
    `state.param_leaves`); the MLPs are differentiated through their own
    parameters."""
    mlp = dict(params.mlps.named_parameters())
    leaves = {name: mlp[name[5:]] if name.startswith("mlps.")
              else x.detach().requires_grad_(True)
              for name, x in st.param_leaves(params).items()}
    p = params._replace(prior=st.prior_from_leaves(leaves),
                        **{name: leaves[name] for name in ANCHOR_FIELDS})
    return p, leaves


def make_train_step(cfg: TrainConfig, width: int, height: int, phase: str,
                    spatial_lr_scale: float, level_scales=(),
                    voxel_size: float = 0.0):
    """The step of one (phase, resolution):
    `step(params, buffers, adam, cam, gt_image, bg, it, with_stats,
    generator=None) -> (params, buffers, adam, metrics)`. Parameters and
    Adam moments are updated in place (see `adam_update`); `with_stats` is a
    Python bool; `generator` draws the noise and context phases' noise. The
    context phase needs the level scales and the voxel size."""
    mcfg, opt, pipe = cfg.model, cfg.opt, cfg.pipe
    _check_phase(phase, mcfg, level_scales)
    level_scales = tuple(level_scales)

    def step(params: Params, buffers: Buffers, adam: AdamState, cam: dict,
             gt_image: torch.Tensor, bg: torch.Tensor, it: int,
             with_stats: bool, generator: torch.Generator | None = None):
        with trace.span("train/step"):
            return _step(params, buffers, adam, cam, gt_image, bg, it,
                         with_stats, generator)

    def _step(params, buffers, adam, cam, gt_image, bg, it, with_stats,
              generator):
        maps = None
        if phase == "context":
            with trace.span("train/levels"):
                maps = kept_level_maps(params, buffers, mcfg, voxel_size,
                                       level_scales)
        p, leaves = _grad_leaves(params)
        nk = params.offsets.shape[0] * mcfg.n_offsets
        screen_dummy = torch.zeros((nk, 2), dtype=torch.float32,
                                   device=params.anchor.device,
                                   requires_grad=True)

        with trace.span("train/render"):
            out = render(p, buffers, mcfg, opt, pipe, cam, width, height, bg,
                         generator, phase=phase, training=True, maps=maps,
                         screen_dummy=screen_dummy)
        with trace.span("train/loss"):
            l1 = l1_loss(out.image, gt_image)
            ssim_v = ssim(out.image, gt_image)
            gv = out.gaussians.gauss_valid
            # three products, not torch.prod: the undecoded slots are zero,
            # and prod's backward then takes a cumprod over all N·K rows
            sc = out.gaussians.scaling
            prod3 = sc[:, 0] * sc[:, 1] * sc[:, 2]
            scaling_reg = (torch.where(gv, prod3, 0.0).sum()
                           / torch.clamp(gv.sum(), min=1))
            loss = (opt.lmbda_rec * ((1.0 - opt.lambda_dssim) * l1
                                     + opt.lambda_dssim * (1.0 - ssim_v))
                    + opt.scaling_reg_weight * scaling_reg)
            bpp = torch.zeros((), device=loss.device)
            if phase == "context":
                bpp = out.aux.rate.bit_per_param
                alive = buffers.alive
                mask_mean = ((torch.sigmoid(p.mask_logit)
                              * alive[:, None]).sum()
                             / torch.clamp(alive.sum() * mcfg.n_offsets,
                                           min=1))
                loss = (loss + opt.lmbda * bpp
                        + opt.mask_reg_weight * mask_mean)

        names = list(leaves)
        with trace.span("train/backward"):
            grads = torch.autograd.grad(loss, [leaves[n] for n in names]
                                        + [screen_dummy], allow_unused=True)
        screen_grad = grads[-1]
        grads = {n: g for n, g in zip(names, grads[:-1]) if g is not None}

        if with_stats:
            g = out.gaussians
            with trace.span("train/stats"):
                buffers = densify.accumulate_stats(
                    buffers, g.neural_opacity.detach(), g.gauss_valid,
                    out.visibility, g.anchor_visible,
                    torch.zeros_like(screen_dummy) if screen_grad is None
                    else screen_grad, mcfg.n_offsets)

        with trace.span("train/adam"):
            params, adam = adam_update(params, grads, adam, opt, it,
                                       spatial_lr_scale)
        with torch.no_grad():
            metrics = StepMetrics(
                loss=loss.detach(), l1=l1.detach(),
                psnr=psnr(out.image.detach(), gt_image),
                bit_per_param=bpp.detach(),
                n_visible_gauss=gv.sum(), overflowed=out.overflowed,
                vis_overflowed=out.vis_overflowed,
                n_instances=out.n_instances, n_vis=out.n_vis)
        return params, buffers, adam, metrics

    return step


def make_eval_render(cfg: TrainConfig, width: int, height: int, phase: str,
                     level_scales=(), voxel_size: float = 0.0):
    """Eval-time render `run(params, buffers, cam, bg, generator=None) ->
    image [3,H,W]`. In the noise phase it draws noise from `generator`, as
    the reference's eval render does; the context phase quantizes by STE
    rounding over the kept set's level maps and draws nothing."""
    mcfg, opt, pipe = cfg.model, cfg.opt, cfg.pipe
    _check_phase(phase, mcfg, level_scales)
    level_scales = tuple(level_scales)

    @torch.no_grad()
    def run(params: Params, buffers: Buffers, cam: dict, bg: torch.Tensor,
            generator: torch.Generator | None = None) -> torch.Tensor:
        maps = None
        if phase == "context":
            maps = kept_level_maps(params, buffers, mcfg, voxel_size,
                                   level_scales)
        return render(params, buffers, mcfg, opt, pipe, cam, width, height,
                      bg, generator, phase=phase, training=False,
                      maps=maps).image

    return run
