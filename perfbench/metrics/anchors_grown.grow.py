"""Anchors a densification round grows: the program's `anchors_grown`
counter (added under `train/densify` after the loop's read-back of the
round's counts), over the rounds in the traced window
(`perfbench/rounds.py`)."""

from perfbench import rounds


def read(r):
    return rounds.counter_per_round(r, "anchors_grown")
