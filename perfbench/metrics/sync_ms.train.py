"""ms a training step in the program's `sync/*` spans: the calls that wait
for the card (read-backs, copies from host memory), on the host clock of
the traced run (`perfbench/spans.py`)."""

from perfbench import spans


def read(r):
    names = spans.sync_names(r)
    return spans.per_unit(r, "host_ms", names) if names else None
