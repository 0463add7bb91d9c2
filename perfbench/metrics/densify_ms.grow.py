"""ms a densification round in the program's `train/densify` span (the
round, the loop's read-back of its counts and any pool growth), on the host
clock of the traced run, over the rounds in the traced window of a growing
cell (`perfbench/rounds.py`)."""

from perfbench import rounds


def read(r):
    return rounds.per_round(r, "host_ms")
