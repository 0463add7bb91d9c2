"""Tile instances a view blends: the program's `tile_instances` counter
(`ops/rasterize/sorting.py`'s `expand_and_sort`, the sort's demand that it
reads back), per unit of the traced window (`perfbench/spans.py`). None
where the program keeps no such counter."""

from perfbench import spans


def read(r):
    return spans.per_unit(r, "counters", "tile_instances")
