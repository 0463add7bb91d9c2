"""ms of device work a densification round of a growing cell: the device
operations launched inside the program's `train/densify` span, each matched
to its launch by the profiler's correlation id, over the rounds in the
traced window (`perfbench/rounds.py`)."""

from perfbench import rounds


def read(r):
    return rounds.per_round(r, "device_ms")
