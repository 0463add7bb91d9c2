"""Anchors a view keeps after the frustum cull: the program's
`visible_anchors` counter (`evaluation.make_decoded_renderer`'s `render`,
the count it reads back after `visible_filter`), per unit of the traced
window (`perfbench/spans.py`). None where the program keeps no such
counter."""

from perfbench import spans


def read(r):
    return spans.per_unit(r, "counters", "visible_anchors")
