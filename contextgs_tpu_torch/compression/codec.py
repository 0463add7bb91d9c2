"""Decoded-scene container (port of
`contextgs_tpu/compression/codec.py::DecodedScene`). The encoder and decoder
come with the codec slice (ROADMAP.md queue 1)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class DecodedScene(NamedTuple):
    """Compacted decoded arrays (the reference's decoded_version state)."""

    anchor: torch.Tensor     # [N,3] dequantized
    feat: torch.Tensor       # [N,F]
    scaling: torch.Tensor    # [N,6] linear (NOT log)
    offsets: torch.Tensor    # [N,K,3]
    masks: torch.Tensor      # [N,K] {0,1}
    hyper: torch.Tensor      # [N,Fh]
    mlps: object             # models.mlps.DecoderMLPs
    prior: dict | None
    level_scales: list
    voxel_size: float
