"""The share of the tile instances binned a unit that the binning's CUDA
kernels binned: the program's `bin_card_instances` counter
(`ops/rasterize/sorting.py`'s `expand_and_sort` on a CUDA device) over its
`tile_instances` counter (every call), per unit of the traced window
(`perfbench/spans.py`). None where the program keeps no such counter."""

from perfbench import spans


def read(r):
    card = spans.per_unit(r, "counters", "bin_card_instances")
    every = spans.per_unit(r, "counters", "tile_instances")
    return card / every if card is not None and every else None
