"""The share of a decode's coded symbols whose CDF rows the card built:
the program's `cdf_card_symbols` counter (`compression/codec._cdf_rows` on
a CUDA device) over its `symbols` counter (`perfbench/spans.py`). None
where the program keeps no such counter."""

from perfbench import spans


def read(r):
    card = spans.per_unit(r, "counters", "cdf_card_symbols")
    symbols = spans.per_unit(r, "counters", "symbols")
    return card / symbols if card is not None and symbols else None
