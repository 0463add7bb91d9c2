"""The share of the gaussians and anchors projected a unit that the
projection's CUDA kernels projected: the program's `proj_card_gaussians`
counter (`ops/rasterize/projection.py`'s `project_gaussians` and
`visible_filter` on a CUDA device) over its `proj_gaussians` counter (every
call), per unit of the traced window (`perfbench/spans.py`). None where the
program keeps no such counter."""

from perfbench import spans


def read(r):
    card = spans.per_unit(r, "counters", "proj_card_gaussians")
    every = spans.per_unit(r, "counters", "proj_gaussians")
    return card / every if card is not None and every else None
