"""Gaussian scene state: fixed-capacity padded parameters and buffers (port
of `contextgs_tpu/models/state.py`).

The pools, the `alive` mask and the leaf names and shapes are those of the
reference, so that its `Params` and `Buffers` carry across through numpy
(see convert.py). The entropy slice is not ported yet: `Params.prior` holds
the reference's factorized-prior tensors as a plain dict when converted, and
is None after the port's own init.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from contextgs_tpu_torch.config import ModelConfig
from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.models.mlps import DecoderMLPs, init_decoder_mlps
from contextgs_tpu_torch.models.quant import mask_ste, quantize_anchor
from contextgs_tpu_torch.ops.knn import mean_knn_sq_dist


class Params(NamedTuple):
    """Optimized leaves, one field per learning-rate group."""

    anchor: torch.Tensor        # [N,3]
    anchor_feat: torch.Tensor   # [N,F]
    hyper_latent: torch.Tensor  # [N,F//hyper_divisor]
    offsets: torch.Tensor       # [N,K,3]
    mask_logit: torch.Tensor    # [N,K]
    scaling_log: torch.Tensor   # [N,6] (3 offset scales + 3 gaussian scales)
    rotation: torch.Tensor      # [N,4] frozen identity
    opacity_raw: torch.Tensor   # [N,1] frozen (render opacity comes from MLP)
    mlps: DecoderMLPs
    prior: dict | None


class Buffers(NamedTuple):
    """Non-optimized state."""

    alive: torch.Tensor             # [N] bool — slot in use
    bound_min: torch.Tensor         # [1,3] anchor quantization bounds
    bound_max: torch.Tensor         # [1,3]
    opacity_accum: torch.Tensor     # [N] densification stats
    anchor_denom: torch.Tensor      # [N]
    offset_grad_accum: torch.Tensor  # [N,K]
    offset_denom: torch.Tensor      # [N,K]


class SceneModel(NamedTuple):
    params: Params
    buffers: Buffers


def get_scaling(params: Params) -> torch.Tensor:
    return torch.exp(params.scaling_log)


def get_mask(params: Params) -> torch.Tensor:
    """[N,K] hard binary per-gaussian mask with STE."""
    return mask_ste(params.mask_logit)


def get_mask_anchor(params: Params, alive: torch.Tensor) -> torch.Tensor:
    """[N] bool — anchor alive iff any offset mask alive."""
    return (get_mask(params).detach().sum(1) > 0) & alive


def get_anchor(params: Params, buffers: Buffers) -> torch.Tensor:
    """16-bit quantized anchors with STE."""
    q, _ = quantize_anchor(params.anchor, buffers.bound_min, buffers.bound_max)
    return q


def update_anchor_bound(buffers: Buffers, anchor: torch.Tensor,
                        alive: torch.Tensor) -> Buffers:
    """Recompute quantization bounds with 1.2/0.8 margins."""
    big = 1e30
    amin = torch.where(alive[:, None], anchor, big).amin(0, keepdim=True)
    amax = torch.where(alive[:, None], anchor, -big).amax(0, keepdim=True)
    bmin = torch.where(amin < 0, amin * 1.2, amin * 0.8)
    bmax = torch.where(amax > 0, amax * 1.2, amax * 0.8)
    return buffers._replace(bound_min=bmin, bound_max=bmax)


def voxelize_points(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Round to the voxel grid + unique."""
    return np.unique(np.round(points / voxel_size), axis=0) * voxel_size


def init_scene_model(points: np.ndarray, cfg: ModelConfig,
                     capacity: int | None = None,
                     generator: torch.Generator | None = None,
                     device=None) -> tuple[SceneModel, float]:
    """Build the padded scene state from an SfM point cloud.

    Returns (model, voxel_size); voxel_size is derived from the kNN median
    when cfg.voxel_size <= 0. The MLP weights come from `generator` (a CPU
    `torch.Generator`), so they differ from the reference's JAX draws."""
    dev = resolve_device(device)
    voxel_size = cfg.voxel_size
    if voxel_size <= 0:
        voxel_size = float(np.median(mean_knn_sq_dist(points)))

    pts = voxelize_points(np.asarray(points, np.float64), voxel_size)
    n = pts.shape[0]
    if capacity is None:
        capacity = cfg.anchor_capacity or int(n * cfg.capacity_headroom)
    capacity = max(capacity, n)
    capacity = ((capacity + 127) // 128) * 128

    dist2 = np.maximum(mean_knn_sq_dist(pts), 1e-7)
    scales0 = np.log(np.sqrt(dist2))[:, None].repeat(6, axis=1)

    def pad(x, fill=0.0):
        out = np.full((capacity,) + x.shape[1:], fill, dtype=np.float32)
        out[:n] = x
        return torch.from_numpy(out).to(dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    f, k_off = cfg.feat_dim, cfg.n_offsets
    mask_logit = zeros(capacity, k_off)
    mask_logit[:n] = 1.0
    rotation = zeros(capacity, 4)
    rotation[:, 0] = 1.0
    params = Params(
        anchor=pad(pts.astype(np.float32)),
        anchor_feat=zeros(capacity, f),
        hyper_latent=zeros(capacity, cfg.hyper_dim),
        offsets=zeros(capacity, k_off, 3),
        mask_logit=mask_logit,
        scaling_log=pad(scales0),
        rotation=rotation,
        opacity_raw=torch.full((capacity, 1), float(np.log(0.1 / 0.9)),
                               dtype=torch.float32, device=dev),
        mlps=init_decoder_mlps(cfg, generator, dev),
        prior=None,
    )
    alive = torch.arange(capacity, device=dev) < n
    buffers = Buffers(
        alive=alive,
        bound_min=zeros(1, 3),
        bound_max=torch.ones((1, 3), dtype=torch.float32, device=dev),
        opacity_accum=zeros(capacity),
        anchor_denom=zeros(capacity),
        offset_grad_accum=zeros(capacity, k_off),
        offset_denom=zeros(capacity, k_off),
    )
    buffers = update_anchor_bound(buffers, params.anchor, alive)
    return SceneModel(params, buffers), voxel_size
