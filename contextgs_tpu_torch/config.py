"""Typed configuration for ContextGS-TPU (PyTorch port's own copy).

A field-for-field copy of `contextgs_tpu/config.py`, so that a config written
by either package reads in the other. The port ignores the Pallas-only
pipeline knobs (`chunk_size`, `tiles_per_gauss_cap`, `backend`,
`rasterize_dtype`): its rasterizer backend follows the device of the tensors.

Replaces the reference's reflection-based argparse groups
(``arguments/__init__.py:47-155`` in /root/reference) with frozen dataclasses.
Defaults match the reference exactly; per-dataset presets reproduce the launcher
scripts (``scripts/train_{tnt,blending,bungeenerf,mlp360}.py``).

TPU-specific additions (capacity / tiling / mesh) have no reference counterpart:
the reference is a single-GPU dynamic-shape program, while every jitted function
here works on fixed-capacity padded anchor pools (SURVEY.md §7).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    """Scene-representation hyperparameters (ref arguments/__init__.py:47-74)."""

    feat_dim: int = 50            # per-anchor feature width
    n_offsets: int = 10           # K gaussians per anchor
    voxel_size: float = 0.001     # <=0 → auto from kNN median (ref gaussian_model.py:387-394)
    update_depth: int = 3         # multi-resolution growing depth
    update_init_factor: int = 16
    update_hierachy_factor: int = 4
    use_feat_bank: bool = False
    hyper_divisor: int = 4        # hyper latent dim = feat_dim // hyper_divisor
    target_ratio: float = 0.2     # per-level keep ratio for the anchor hierarchy
    level_num: int = 3            # number of context levels (ref train.py:598)
    n_features: int = 4           # vestigial in ref; kept for config parity
    white_background: bool = False
    resolution: int = -1
    eval: bool = True
    lod: int = 0                  # >0 → first `lod` cameras become the test split

    # --- quantization steps (ref gaussian_renderer/__init__.py:40-42) ---
    q_feat: float = 1.0
    q_scaling: float = 0.001
    q_offsets: float = 0.2
    anchor_round_digits: int = 16  # anchor xyz quantized to 16 bits/coord (ref encodings.py:10)

    # --- TPU-specific static-shape knobs (no reference counterpart) ---
    anchor_capacity: int = 0       # 0 → derived from initial point cloud; padded pool size
    capacity_headroom: float = 4.0  # initial capacity = headroom * n_init_anchors

    @property
    def hyper_dim(self) -> int:
        return self.feat_dim // self.hyper_divisor

    @property
    def context_dim(self) -> int:
        # parent context = [anchor_xyz(3), feat(feat_dim), scaling(6)]
        # (ref gaussian_model.py:1711-1724)
        return self.feat_dim + 6 + 3


@dataclass(frozen=True)
class OptimizationConfig:
    """Training schedule and learning rates (ref arguments/__init__.py:83-155)."""

    iterations: int = 30_000

    offset_lr_init: float = 0.01
    offset_lr_final: float = 0.0001
    offset_lr_delay_mult: float = 0.01
    offset_lr_max_steps: int = 30_000

    mask_lr_init: float = 0.01
    mask_lr_final: float = 0.0001
    mask_lr_delay_mult: float = 0.01
    mask_lr_max_steps: int = 30_000

    anchor_lr: float = 0.0         # ref position_lr_init = 0.0 → anchors frozen
    feature_lr: float = 0.0075
    hyper_latent_lr: float = 0.0075
    opacity_lr: float = 0.02
    scaling_lr: float = 0.007
    rotation_lr: float = 0.002

    mlp_opacity_lr_init: float = 0.002
    mlp_opacity_lr_final: float = 0.00002
    mlp_opacity_lr_delay_mult: float = 0.01
    mlp_opacity_lr_max_steps: int = 30_000

    mlp_cov_lr_init: float = 0.004
    mlp_cov_lr_final: float = 0.004
    mlp_cov_lr_delay_mult: float = 0.01
    mlp_cov_lr_max_steps: int = 30_000

    mlp_color_lr_init: float = 0.008
    mlp_color_lr_final: float = 0.00005
    mlp_color_lr_delay_mult: float = 0.01
    mlp_color_lr_max_steps: int = 30_000

    mlp_featurebank_lr_init: float = 0.01
    mlp_featurebank_lr_final: float = 0.00001
    mlp_featurebank_lr_delay_mult: float = 0.01
    mlp_featurebank_lr_max_steps: int = 30_000

    latent_codec_lr_init: float = 0.005
    latent_codec_lr_final: float = 0.00001
    latent_codec_lr_delay_mult: float = 0.33
    latent_codec_lr_max_steps: int = 30_000

    mlp_grid_lr_init: float = 0.005
    mlp_grid_lr_final: float = 0.00001
    mlp_grid_lr_delay_mult: float = 0.01
    mlp_grid_lr_max_steps: int = 30_000

    # codec/grid MLP schedules are shifted by `step_sub` steps because they only
    # start mattering once entropy training begins (ref gaussian_model.py:513,519)
    step_sub: int = 10_000

    lambda_dssim: float = 0.2
    lmbda: float = 0.001           # rate weight λ (ref train.py:614)
    lmbda_rec: float = 1.0         # reconstruction weight (ref train.py:615)
    mask_reg_weight: float = 5e-4  # Σ sigmoid(mask) regularizer (ref train.py:207)
    scaling_reg_weight: float = 0.01  # Π scaling regularizer (ref train.py:203-205)

    # densification (ref arguments/__init__.py:146-153)
    start_stat: int = 500
    update_from: int = 1500
    update_interval: int = 100
    update_until: int = 15_000
    min_opacity: float = 0.005
    success_threshold: float = 0.8
    densify_grad_threshold: float = 0.0002

    # entropy-training schedule boundaries (ref gaussian_renderer/__init__.py:54-73)
    noise_from: int = 3000         # uniform-noise quantization starts after this
    context_from: int = 10_000     # full context model + rate loss after this

    # fraction of anchors sampled for the rate loss each step
    # (ref gaussian_model.py:1658, chosse_random_thresh=0.15)
    rate_sample_frac: float = 0.15

    disable_hyper: bool = False    # zero the hyper latent (ref train.py:616)


@dataclass(frozen=True)
class PipelineConfig:
    """Renderer / execution options (ref arguments/__init__.py:76-81 + TPU knobs)."""

    debug: bool = False
    tile_size: int = 16            # pixels per tile side (matches CUDA reference BLOCK_X/Y)
    tiles_per_gauss_cap: int = 32  # static cap on tiles one splat may cover
    chunk_size: int = 256          # instances blended per inner-kernel chunk
    backend: str = "auto"          # "pallas" | "jax" | "auto"
    rasterize_dtype: str = "float32"


@dataclass(frozen=True)
class TrainConfig:
    """Top-level run config: model + optimization + pipeline + IO."""

    model: ModelConfig = field(default_factory=ModelConfig)
    opt: OptimizationConfig = field(default_factory=OptimizationConfig)
    pipe: PipelineConfig = field(default_factory=PipelineConfig)

    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    seed: int = 0
    test_iterations: tuple = (30_000,)
    save_iterations: tuple = (30_000,)
    checkpoint_iterations: tuple = ()
    start_checkpoint: Optional[str] = None
    log_every: int = 100

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @staticmethod
    def from_json(s: str) -> "TrainConfig":
        d = json.loads(s)
        return TrainConfig(
            model=ModelConfig(**d.pop("model")),
            opt=OptimizationConfig(**d.pop("opt")),
            pipe=PipelineConfig(**d.pop("pipe")),
            **{k: (tuple(v) if isinstance(v, list) else v) for k, v in d.items()},
        )


# ---------------------------------------------------------------------------
# Per-dataset presets, mirroring the reference launcher scripts
# (ref scripts/train_tnt.py, train_blending.py, train_bungeenerf.py,
#  train_mlp360.py, train_scripts/run_shell_blender.py:5).
# ---------------------------------------------------------------------------

_PRESETS = {
    "mipnerf360": dict(voxel_size=0.001, update_init_factor=16),
    "tandt": dict(voxel_size=0.01, update_init_factor=16),
    "deep_blending": dict(voxel_size=0.005, update_init_factor=16),
    "nerf_synthetic": dict(voxel_size=0.001, update_init_factor=4, white_background=True),
    "bungeenerf": dict(voxel_size=0.0, update_init_factor=128, lod=30),
}


def preset(name: str, **overrides) -> ModelConfig:
    """Per-dataset ModelConfig matching the reference launcher hyperparameters."""
    if name not in _PRESETS:
        raise KeyError(f"unknown preset {name!r}; options: {sorted(_PRESETS)}")
    kw = dict(_PRESETS[name])
    kw.update(overrides)
    return ModelConfig(**kw)
