"""The share of the keys carried a unit that the carry kernel carried: the
program's `carry_card_keys` counter (`models/levels.py`'s `segmented_carry`
on a CUDA device, `ops/carry.py`) over its `carry_keys` counter (every call:
the level maps, a densify round's occupied voxels), per unit of the traced
window (`perfbench/spans.py`). None where the program keeps no such
counter."""

from perfbench import spans


def read(r):
    card = spans.per_unit(r, "counters", "carry_card_keys")
    every = spans.per_unit(r, "counters", "carry_keys")
    return card / every if card is not None and every else None
