"""Optimizer: one hand-written Adam with per-group log-lerp learning-rate
schedules (port of `contextgs_tpu/train/optim.py`).

Not `torch.optim.Adam`: the moments are plain tensors aligned with the padded
anchor pool, so densification zeroes the rows of the slots it activates
(`models/densify.py`), and the update matches the reference's arithmetic
(eps 1e-15, bias-corrected, one lr per group). The learning rates are Python
floats computed on the host from the step number, so no schedule value
reaches the card.

On CUDA tensors one hand-written kernel, `csrc/adam.cu`, updates every
leaf's parameter and moments in one launch; on CPU tensors the plain op chain
(`chain_update`) runs, op for op the reference's update. The chain is the
kernel's plain version: on the card the two are bit-equal.

Groups with schedules: offset, mask, mlp_opacity, mlp_cov, mlp_color,
latent_codec (prior), mlp_grid, mlp_featurebank (and anchor, whose lr is 0:
anchors are frozen). Constant lr: anchor_feat, hyper_latent, opacity,
scaling. Rotation and opacity_raw are frozen (lr 0).
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from contextgs_tpu_torch.config import OptimizationConfig
from contextgs_tpu_torch.models.state import Params, param_leaves
from contextgs_tpu_torch.ops.cuda_build import c_function, launch
from contextgs_tpu_torch.utils import trace

SOURCE = Path(__file__).resolve().parent / "csrc" / "adam.cu"
MAX_LEAVES = 64          # adam.cu's kMaxLeaves: the leaves of one launch
# n, the pointer, size and lr tables, seven float32 scalars, the stream
ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_float] * 7
            + [ctypes.c_void_p])

launches = 0             # the kernel's launches in this process


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


def bias_corrections(count: int, b1: float, b2: float) -> tuple:
    """1 - b1**count and 1 - b2**count, rounded to float32 on the host as
    the reference computes them."""
    cf = torch.tensor(float(count), dtype=torch.float32)
    return (float(1 - torch.tensor(b1, dtype=torch.float32) ** cf),
            float(1 - torch.tensor(b2, dtype=torch.float32) ** cf))


def chain_update(p, g, m, v, lr: float, b1: float, b2: float, bc1: float,
                 bc2: float, eps: float) -> None:
    """One leaf's update by the plain op chain, in place: the CPU's path and
    the kernel's plain version. A leaf without a gradient (`g` None) is
    updated with a zero one."""
    if g is None:
        g = torch.zeros_like(p)
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * (g * g))
    p.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))


def _kernel_leaf(name, p, g, m, v, device):
    """The leaf's gradient as the kernel reads it: contiguous (a copy only
    where it is a view; on the main path every gradient is contiguous), or
    None. Raises ValueError unless p, m, v and g are float32 tensors of p's
    shape on `device`, p, m and v contiguous: the kernel updates them in
    place."""
    for what, x in (("p", p), ("m", m), ("v", v), ("g", g)):
        if x is None:
            continue
        if (x.device != device or x.dtype != torch.float32
                or x.shape != p.shape):
            raise ValueError(
                f"adam_update: {name}.{what} is {x.dtype} {tuple(x.shape)} "
                f"on {x.device}; the kernel takes float32 "
                f"{tuple(p.shape)} on {device}")
        if what != "g" and not x.is_contiguous():
            raise ValueError(f"adam_update: {name}.{what} is not contiguous")
    return None if g is None else g.contiguous()


def _adam_kernel(leaves, device, b1, b2, bc1, bc2, eps) -> None:
    """`csrc/adam.cu` over `leaves` [(p, g, m, v, lr)], each non-empty, in
    one launch. The table goes to the C function as three host arrays
    (numpy builds them faster than ctypes): p, g, m, v pointers a leaf (0
    for a missing g), the sizes and the lrs as float32."""
    global launches
    if len(leaves) > MAX_LEAVES:
        raise ValueError(f"adam_update: {len(leaves)} leaves; one launch "
                         f"takes at most {MAX_LEAVES}")
    fn = c_function(SOURCE, "adam_leaves", ARGTYPES)
    ptrs = np.array([0 if x is None else x.data_ptr()
                     for leaf in leaves for x in leaf[:4]], np.uint64)
    numel = np.array([leaf[0].numel() for leaf in leaves], np.int64)
    lrs = np.array([leaf[4] for leaf in leaves], np.float32)
    err = launch(fn, device, len(leaves), ptrs.ctypes.data, numel.ctypes.data,
                 lrs.ctypes.data, b1, 1 - b1, b2, 1 - b2, bc1, bc2, eps)
    if err != 0:
        raise RuntimeError(f"adam_update: kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1


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
    is returned with a new AdamState.

    On a CUDA device every leaf goes to the kernel, one launch for all of
    them, bit-equal to the op chain there (a leaf of another dtype, shape or
    device raises ValueError); on the CPU `chain_update` updates each leaf.
    Every leaf's elements are added to the trace counter `adam_elems`, the
    kernel's to `adam_card_elems` too."""
    lrs = group_lrs(opt, step, spatial_lr_scale)
    count = state.count + 1
    bc1, bc2 = bias_corrections(count, b1, b2)
    leaves = param_leaves(params)
    device = next(iter(leaves.values())).device
    card, n_elems = [], 0
    for name, p in leaves.items():
        g, m, v = grads.get(name), state.mu[name], state.nu[name]
        lr = leaf_lr(name, lrs)
        n_elems += p.numel()
        if device.type != "cuda":
            chain_update(p, g, m, v, lr, b1, b2, bc1, bc2, eps)
        elif p.numel():
            card.append((p, _kernel_leaf(name, p, g, m, v, device), m, v, lr))
    if card:
        _adam_kernel(card, device, b1, b2, bc1, bc2, eps)
    trace.count("adam_elems", n_elems)
    trace.count("adam_card_elems", n_elems if device.type == "cuda" else 0)
    return params, AdamState(mu=state.mu, nu=state.nu, count=count)
