"""Multi-level anchor hierarchy (port of `contextgs_tpu/models/levels.py`).

Only `segmented_carry` so far, which densification's voxel grouping uses;
the level maps come with the context slice (ROADMAP.md queue 1, slice 3).
"""

from __future__ import annotations

import torch


def segmented_carry(is_start: torch.Tensor,
                    values: torch.Tensor) -> torch.Tensor:
    """Forward-fill `values` from segment starts: out[i] = values[j] for the
    latest j ≤ i with is_start[j], and values[0] before the first start, as
    the reference's associative scan gives."""
    n = is_start.shape[0]
    idx = torch.arange(n, device=is_start.device)
    last_start = torch.cummax(torch.where(is_start, idx, 0), 0).values
    return values[last_start]
