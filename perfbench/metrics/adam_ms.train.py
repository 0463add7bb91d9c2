"""ms a training step in the program's `train/adam` span (the hand-written
Adam over every leaf), on the host clock of the traced run
(`perfbench/spans.py`)."""

from perfbench import spans


def read(r):
    return spans.per_unit(r, "host_ms", "train/adam")
