"""The share of the elements Adam updated a unit that its CUDA kernel
updated: the program's `adam_card_elems` counter (`train/optim.py`'s
`adam_update`, the leaves its kernel took) over its `adam_elems` counter
(every element of every leaf), per unit of the traced window
(`perfbench/spans.py`). None where the program keeps no such counter."""

from perfbench import spans


def read(r):
    card = spans.per_unit(r, "counters", "adam_card_elems")
    every = spans.per_unit(r, "counters", "adam_elems")
    return card / every if card is not None and every else None
