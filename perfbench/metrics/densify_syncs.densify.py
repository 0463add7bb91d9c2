"""Waits for the card a densification round: the program's `syncs` counter
as the `sync/*` spans under `train/densify` add to it, over the rounds in
the traced window (`perfbench/rounds.py`)."""

from perfbench import rounds


def read(r):
    return rounds.counter_per_round(r, "syncs")
