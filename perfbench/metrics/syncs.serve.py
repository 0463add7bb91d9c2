"""Waits for the card a view: the program's `syncs` counter, which each
`sync/*` span adds its call's waits to (`perfbench/spans.py`)."""

from perfbench import spans


def read(r):
    return spans.per_unit(r, "counters", "syncs")
