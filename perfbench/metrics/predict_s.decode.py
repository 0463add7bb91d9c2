"""Seconds a decode in the program's `codec/predict` spans (each level's μ,
σ and Q by the grid MLPs, and their read-back to the host), on the host
clock of the traced run (`perfbench/spans.py`)."""

from perfbench import spans


def read(r):
    return spans.per_unit(r, "host_ms", "codec/predict", scale=1e-3)
