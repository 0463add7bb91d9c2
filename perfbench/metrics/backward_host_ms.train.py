"""ms a training step in the program's `train/backward` span (autograd
through K2, the MLPs and the context model), on the host clock of the
traced run (`perfbench/spans.py`)."""

from perfbench import spans


def read(r):
    return spans.per_unit(r, "host_ms", "train/backward")
