"""ms a training step in the program's `train/stats` span (the
densification statistics of the step), on the host clock of the traced
run (`perfbench/spans.py`)."""

from perfbench import spans


def read(r):
    return spans.per_unit(r, "host_ms", "train/stats")
