"""The reader of the program's densification rounds in a traced run: the
`train/densify` spans (a round, the loop's read-back of its counts and any
pool growth) and what lies under them, per round. Metric files import it,
as they import `spans.py`.

The span totals are `spans.read`'s. The counters under a round need the
spans' nesting, which the totals do not keep: the densify kind's traced
window (`kinds/densify.Traced`) keeps the records as `spans.read` takes
them, whichever metric reads first.
"""

from __future__ import annotations

from perfbench import spans

ROUND = "train/densify"


def _read(reading):
    table = spans.read(reading)
    kept = getattr(reading.window, "records", None)
    if table is None or not table.count.get(ROUND) or not kept:
        return None
    events = reading.tracer.prof.profiler.kineto_results.events()
    nodes, _ = spans._nest(spans.program_spans(
        kept[0], spans.window(events, "pb:window")))
    return table, nodes, kept[0].counts


def read(reading):
    """(`spans.Spans`, {id: nested span}, the counts) of the traced window,
    read once; None where the program recorded no round there."""
    return reading.cached("program_rounds", lambda: _read(reading))


def per_round(reading, field: str):
    """`field` (a dict of `spans.Spans`) of the round span, per round."""
    got = read(reading)
    if got is None:
        return None
    table = got[0]
    return getattr(table, field).get(ROUND, 0.0) / table.count[ROUND]


def counter_per_round(reading, name: str):
    """The counter `name` added under the round spans, per round."""
    got = read(reading)
    if got is None:
        return None
    table, nodes, counts = got

    def in_round(sid):
        while sid is not None and sid in nodes:
            if nodes[sid].name == ROUND:
                return True
            sid = nodes[sid].parent
        return False

    total = sum(c.n for c in counts if c.name == name and in_round(c.span))
    return total / table.count[ROUND]
