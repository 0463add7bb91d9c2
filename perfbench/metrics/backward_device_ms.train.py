"""ms a training step of device work launched inside the program's
`train/backward` span, autograd's device thread included (its spans nest by
time under the step's), matched by correlation id (`perfbench/spans.py`)."""

from perfbench import spans


def read(r):
    return spans.per_unit(r, "device_ms", "train/backward")
