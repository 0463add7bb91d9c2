"""ms a training step of device work launched inside the program's
`train/render` span: each device operation's time, matched to its launch
by the profiler's correlation id (`perfbench/spans.py`)."""

from perfbench import spans


def read(r):
    return spans.per_unit(r, "device_ms", "train/render")
