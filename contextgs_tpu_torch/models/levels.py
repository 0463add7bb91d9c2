"""Multi-level anchor hierarchy (port of `contextgs_tpu/models/levels.py`).

Two per-anchor arrays of the padded pool describe the levels:

- ``level[a]``: the highest level anchor `a` belongs to (coding runs coarse
  to fine, so `a` is entropy-coded once, at level[a]);
- ``parent[a]``: the index of the representative of `a`'s voxel at the next
  coarser level, its context source; parent[a] = a at the coarsest level.

Voxel-unique is sort-based: stable sorts key by key, last key first, from
the identity order, sort the three rounded coordinates lexicographically with
the original index as the tie-break, so the first occupant of each voxel
represents it, bit for bit as the reference's `lax.sort` does.

`find_divide_scale` (host numpy) binary-searches the per-level voxel scale
for a `target_ratio` unique fraction; it runs once and is kept in
checkpoints.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from contextgs_tpu_torch.ops import carry
from contextgs_tpu_torch.utils import trace

_SENTINEL = 2 ** 30        # the voxel key of invalid slots


class LevelMaps(NamedTuple):
    level: torch.Tensor     # [N] int32 in [0, level_num)
    parent: torch.Tensor    # [N] int32 original-space parent index
    counts: torch.Tensor    # [level_num] anchors whose level == i


def segmented_carry_plain(is_start: torch.Tensor,
                          values: torch.Tensor) -> torch.Tensor:
    """The plain version of `segmented_carry`, which CPU tensors take: the
    last start at or before each key by `torch.cummax` over the start
    indices, then a gather."""
    n = is_start.shape[0]
    idx = torch.arange(n, device=is_start.device)
    last_start = torch.cummax(torch.where(is_start, idx, 0), 0).values
    return values[last_start]


def segmented_carry(is_start: torch.Tensor,
                    values: torch.Tensor) -> torch.Tensor:
    """Forward-fill `values` from segment starts: out[i] = values[j] for the
    latest j ≤ i with is_start[j], and values[0] before the first start, as
    the reference's associative scan gives. On CUDA tensors one launch of
    the carry kernel (`ops/carry.py`), on CPU tensors `segmented_carry_plain`;
    either raises on what the kernel does not take (`carry.check`). Every
    call adds its keys to the trace counter `carry_keys`, a kernel call to
    `carry_card_keys` too."""
    if is_start.device.type == "cuda":
        out = carry.segmented_carry(is_start, values)
        trace.count("carry_keys", out.shape[0])
        trace.count("carry_card_keys", out.shape[0])
        return out
    trace.count("carry_keys", carry.check(is_start, values))
    return segmented_carry_plain(is_start, values)


def _voxel_unique_representative(keys: torch.Tensor, valid: torch.Tensor):
    """keys [N,3] int32 voxel coordinates (+ valid mask) → (is_representative
    [N] bool, rep_index [N] int64: the original index of the first occupant
    of the element's voxel). Invalid elements share a sentinel voxel and are
    excluded."""
    n = keys.shape[0]
    cols = [torch.where(valid, keys[:, j], _SENTINEL) for j in range(3)]
    order = torch.arange(n, device=keys.device)
    for col in reversed(cols):
        order = order[torch.sort(col[order], stable=True).indices]
    sx, sy, sz = (c[order] for c in cols)
    new_group = torch.ones(n, dtype=torch.bool, device=keys.device)
    new_group[1:] = ((sx[1:] != sx[:-1]) | (sy[1:] != sy[:-1])
                     | (sz[1:] != sz[:-1]))
    rep_sorted = segmented_carry(new_group, order)
    rep = torch.empty_like(order)
    rep[order] = rep_sorted
    is_rep = torch.empty_like(new_group)
    is_rep[order] = new_group
    idx = torch.arange(n, device=keys.device)
    return is_rep & valid, torch.where(valid, rep, idx)


def build_level_maps(anchors: torch.Tensor, alive: torch.Tensor,
                     voxel_size: float, level_scales, level_num: int
                     ) -> LevelMaps:
    """Level membership and parents of every pool slot.

    anchors: [N,3] quantized anchor positions; alive: [N] bool, the members
    of level 0 (the training step passes the kept set, alive ∧ mask_anchor).
    Other slots join no level above 0 and never represent a voxel. Level i
    keys are the rounded positions of level i−1's members at the scale
    voxel_size · level_scales[i−1]."""
    n = anchors.shape[0]
    dev = anchors.device
    level = torch.zeros(n, dtype=torch.int32, device=dev)
    parent = torch.arange(n, device=dev)
    member = alive
    for i in range(1, level_num):
        # a float32 tensor, not a Python scalar: CUDA divides by a host scalar
        # as a product with its reciprocal, which may round otherwise
        with trace.sync("levels.scale"):
            scale = torch.tensor(voxel_size * float(level_scales[i - 1]),
                                 dtype=torch.float32, device=dev)
        pos = torch.where(member[:, None], anchors, 0.0)
        keys = torch.round(pos / scale).to(torch.int32)
        is_rep, rep = _voxel_unique_representative(keys, member)
        parent = torch.where(member & ~is_rep, rep, parent)
        level = torch.where(is_rep, i, level)
        member = is_rep
    lv = torch.where(alive, level, -1)
    counts = torch.stack([(lv == i).sum() for i in range(level_num)])
    return LevelMaps(level=torch.where(alive, level, 0).to(torch.int32),
                     parent=parent.to(torch.int32),
                     counts=counts.to(torch.int32))


def find_divide_scale(anchors: np.ndarray, voxel_size: float,
                      bound_min: np.ndarray, bound_max: np.ndarray,
                      target_ratio: float, level_num: int) -> list:
    """Host binary search for the per-level voxel scales."""
    scale_upper0 = float(((bound_max - bound_min) / voxel_size).max())

    def search(upper, lower, pts):
        while True:
            scale = (upper + lower) / 2
            uniq = np.unique(np.round(pts / voxel_size / scale), axis=0) \
                * voxel_size * scale
            ratio = uniq.shape[0] / pts.shape[0]
            if abs(ratio - target_ratio) < 0.01 or abs(upper - lower) < 1:
                return scale, uniq
            if ratio < target_ratio:
                upper = scale
            else:
                lower = scale

    pts = np.asarray(anchors, dtype=np.float64)
    scales = []
    lower = 1.0
    upper = scale_upper0
    for _ in range(level_num - 1):
        scale, pts = search(upper, lower, pts)
        lower = scale
        scales.append(float(scale))
    return scales
