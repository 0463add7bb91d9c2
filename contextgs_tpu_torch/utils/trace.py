"""Spans and counters at the port's layer boundaries.

`span(name)` is a context manager around one layer's work; `count(name, n)`
adds `n` to a counter; `sync(where, waits)` is the span `sync/<where>`
around one call that waits for the device `waits` times on a CUDA card (a
read back to the host, or a copy from host memory, which synchronises the
stream), and adds `waits` to the counter `syncs`. They record only while a
torch profiler is recording (`torch.autograd.profiler._is_profiler_enabled`,
the flag torch keeps for fast Python checks); otherwise each costs one
attribute read, and a span returns a shared null context. There is no
other switch.

While on, each span keeps a `Span` in memory: its id, name, the id of the
span open around it on the same thread (`parent`), the id of the outermost
one (`unit`: a training step, a view, a decode), the thread's native id and
its start and end in ns on the wall clock (`time.time_ns`), the clock torch's
profiler stamps its events with, so a span lines up with the trace's host
events without a shift. A count keeps a
`Count` against the innermost span open on its thread. `take()` hands the
records over and clears them.

The tracer adds no device synchronisation (it reads no tensor: a count is a
number the host already holds) and no profiler annotation, so a traced run's
device timeline is the program's own. Names are `layer/what`.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

from torch.autograd import profiler as _profiler


class Span(NamedTuple):
    id: int
    name: str
    parent: int | None
    unit: int
    thread: int
    start_ns: int
    end_ns: int


class Count(NamedTuple):
    name: str
    span: int | None     # the innermost span open on the counting thread
    n: int


class Records(NamedTuple):
    spans: list
    counts: list


class _Local(threading.local):
    def __init__(self):
        self.stack = []      # the spans open on this thread, innermost last
        self.thread = threading.get_native_id()


_NULL = contextlib.nullcontext()
_ids = itertools.count()
_local = _Local()
_spans: list = []
_counts: list = []


class _Open:
    __slots__ = ("name", "waits", "id", "parent", "unit", "start")

    def __init__(self, name: str, waits: int = 0):
        self.name, self.waits = name, waits

    def __enter__(self):
        stack = _local.stack
        self.id = next(_ids)
        if stack:
            self.parent, self.unit = stack[-1].id, stack[-1].unit
        else:
            self.parent, self.unit = None, self.id
        stack.append(self)
        if self.waits:
            _counts.append(Count("syncs", self.id, self.waits))
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.stack.pop()
        _spans.append(Span(self.id, self.name, self.parent, self.unit,
                           _local.thread, self.start, end))
        return False


def span(name: str):
    """A span named `name` around the `with` block, recorded while a torch
    profiler records."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Open(name)


def sync(where: str, waits: int = 1):
    """The span `sync/<where>` around a call that waits for a CUDA device
    `waits` times, counted into `syncs`; no span where `waits` is 0."""
    if not _profiler._is_profiler_enabled or not waits:
        return _NULL
    return _Open("sync/" + where, waits)


def count(name: str, n: int) -> None:
    """Add `n` (a host number) to the counter `name`, against the innermost
    open span, while a torch profiler records."""
    if not _profiler._is_profiler_enabled:
        return
    stack = _local.stack
    _counts.append(Count(name, stack[-1].id if stack else None, n))


def take() -> Records:
    """The spans (in the order they ended) and counts recorded since the
    last call; clears them."""
    spans, counts = _spans[:], _counts[:]
    del _spans[:len(spans)], _counts[:len(counts)]
    return Records(spans, counts)


def summary(records: Records, root: str) -> dict:
    """Per span name over the records, per `root` span (a unit): the
    count, total ms and self ms (less the part of its interval that its
    children on the same thread cover), and each counter's total."""
    spans = records.spans
    units = sum(1 for s in spans if s.name == root) or 1
    children: dict = {}
    for s in spans:
        if s.parent is not None:
            children.setdefault(s.parent, []).append(s)
    out: dict = {}
    for s in spans:
        covered, edge = 0, s.start_ns
        for c in sorted(children.get(s.id, ()), key=lambda c: c.start_ns):
            lo, hi = max(c.start_ns, edge), min(c.end_ns, s.end_ns)
            if hi > lo:
                covered += hi - lo
                edge = hi
        row = out.setdefault(s.name, [0, 0, 0])
        row[0] += 1
        row[1] += s.end_ns - s.start_ns
        row[2] += s.end_ns - s.start_ns - covered
    counters: dict = {}
    for c in records.counts:
        counters[c.name] = counters.get(c.name, 0) + c.n
    return {"units": units, "root": root,
            "spans": {name: {"count": n / units, "ms": total / 1e6 / units,
                             "self_ms": own / 1e6 / units}
                      for name, (n, total, own) in sorted(out.items())},
            "counters": {name: n / units
                         for name, n in sorted(counters.items())}}
