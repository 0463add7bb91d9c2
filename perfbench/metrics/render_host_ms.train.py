"""ms a training step in the program's `train/render` span (the forward:
cull, decode with the context model, projection, binning, K1), on the host
clock of the traced run (`perfbench/spans.py`)."""

from perfbench import spans


def read(r):
    return spans.per_unit(r, "host_ms", "train/render")
