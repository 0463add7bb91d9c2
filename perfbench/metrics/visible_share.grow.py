"""The share of a step's pool-wide work that serves what the view sees: the
anchors the training render's cull keeps (the program's
`render_visible_anchors` counter, `models/renderer.render`) over the pool
rows the noise or context phase draws for and quantizes (its
`context_rows` counter, `models/decode.phase_inputs`), summed over the
traced window (`perfbench/spans.py`). None where the program keeps either
counter not."""

from perfbench import spans


def read(r):
    got = spans.read(r)
    if got is None:
        return None
    kept = got.counters.get("render_visible_anchors")
    rows = got.counters.get("context_rows")
    if not kept or not rows:
        return None
    return kept / rows
