"""The reader of the program's own spans and counters
(`contextgs_tpu_torch/utils/trace.py`) in a traced run. Metric files import
it, as they import `roofline.py`; it enables nothing.

The program records its spans while the harness's profiler records, on the
clock the profiler stamps its events with (the wall clock). The reader takes
them (`trace.take()`, once a reading) and keeps those inside the traced
window, the `pb:window` annotation that the harness opens just before
`tracer.t0` and closes just after `tracer.t1`. Then:

- a span without a parent on its own thread that lies inside a span of
  another thread is nested, by time, under the innermost such span (the
  tile blend's backward runs on autograd's device thread, inside the
  step's `train/backward`); the other parentless spans are the units;
- per span name: the count, host ms (the spans' durations) and self ms
  (less the part its children cover);
- device ms per span name: each device operation is matched by the
  profiler's correlation id to the CUDA runtime or driver call that
  launched it, and its time is counted for the innermost span, on any
  thread, whose host interval holds that call, and for each span around
  it (`device_ms`);
- the device's idle time in the window, split by the innermost span open
  on the units' thread, or "outside".

A program without the tracer, or a run that recorded no span, gives None,
and so does every metric read from it.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

OUTSIDE = "outside"
# names of the CUDA runtime and driver calls that launch device work
LAUNCH_PREFIXES = ("cuda", "cu")


class Span(NamedTuple):
    id: int
    name: str
    parent: int | None
    unit: int
    thread: int
    start: int           # ns on the profiler's clock
    end: int


class Launch(NamedTuple):
    corr: int            # the profiler's correlation id
    start: int           # ns on the profiler's clock


class DeviceOp(NamedTuple):
    name: str
    corr: int
    start: int
    end: int


class Spans(NamedTuple):
    units: int                  # parentless spans covered by no other thread
    count: dict                 # name → spans
    host_ms: dict               # name → ms, summed durations
    self_ms: dict               # name → ms, less the children's cover
    device_ms: dict             # name → ms of the operations launched inside
    device_self_ms: dict        # name → ms, launched with it innermost
    counters: dict              # name → total
    kernels: int                # kernels (not copies or fills) in the window
    kernels_in_units: int       # of them, launched inside a unit
    idle_ms: dict               # innermost span on the units' thread → ms


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def _nest(spans: list) -> tuple:
    """({id: span} with each cross-thread orphan nested under its innermost
    covering span on another thread, the ids of the units)."""
    ids = {s.id for s in spans}
    by_thread: dict = {}
    for s in spans:
        by_thread.setdefault(s.thread, []).append(s)
    out, units = {}, set()
    for s in spans:
        if s.parent in ids:
            out[s.id] = s
            continue
        cover = [c for t, own in by_thread.items() if t != s.thread
                 for c in own if c.start <= s.start and s.end <= c.end]
        if cover:
            c = max(cover, key=lambda c: (c.start, -c.end))
            out[s.id] = s._replace(parent=c.id)
        else:
            out[s.id] = s._replace(parent=None)
            units.add(s.id)

    def unit(sid):
        parent = out[sid].parent
        return sid if parent is None else unit(parent)

    return {i: s._replace(unit=unit(i)) for i, s in out.items()}, units


def _timeline(spans) -> tuple:
    """(boundaries, innermost span id or None in each piece between them):
    the innermost span is the open one that started last."""
    spans = sorted(spans, key=lambda s: s.start)
    edges = sorted({t for s in spans for t in (s.start, s.end)})
    inner, open_, i = [], [], 0
    for a in edges[:-1]:
        while i < len(spans) and spans[i].start <= a:
            open_.append(spans[i])
            i += 1
        open_ = [s for s in open_ if s.end > a]
        inner.append(max(open_, key=lambda s: (s.start, -s.end)).id
                     if open_ else None)
    return edges, inner


def _at(timeline, t) -> int | None:
    edges, inner = timeline
    i = bisect.bisect_right(edges, t) - 1
    return inner[i] if 0 <= i < len(inner) else None


def _merge(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def analyse(spans: list, counts: list, launches: list, device_ops: list,
            window: tuple) -> Spans | None:
    """The reading of `spans` (`Span`, profiler clock) and `counts`
    (`trace.Count`) against the device operations launched by `launches`,
    over `window` = (start ns, end ns); None without spans."""
    if not spans:
        return None
    nodes, units = _nest(spans)
    children: dict = {}
    for s in nodes.values():
        if s.parent is not None:
            children.setdefault(s.parent, []).append(s)
    count: dict = {}
    host: dict = {}
    own: dict = {}
    for s in nodes.values():
        covered = sum(e - b for b, e in _merge(
            (max(c.start, s.start), min(c.end, s.end))
            for c in children.get(s.id, ()) if c.end > s.start
            and c.start < s.end))
        count[s.name] = count.get(s.name, 0) + 1
        host[s.name] = host.get(s.name, 0.0) + (s.end - s.start) / 1e6
        own[s.name] = own.get(s.name, 0.0) + (s.end - s.start - covered) / 1e6

    a, b = window
    ops = [op._replace(start=max(op.start, a), end=min(op.end, b))
           for op in device_ops if op.end > a and op.start < b]
    launched = {x.corr: x.start for x in launches}
    timeline = _timeline(nodes.values())
    dev: dict = {}
    dev_self: dict = {}
    kernels = in_units = 0
    for op in ops:
        t = launched.get(op.corr)
        sid = None if t is None else _at(timeline, t)
        if _is_kernel(op.name):
            kernels += 1
            in_units += sid is not None and nodes[sid].unit in units
        if sid is None:
            continue
        ms = (op.end - op.start) / 1e6
        name = nodes[sid].name
        dev_self[name] = dev_self.get(name, 0.0) + ms
        seen = set()
        while sid is not None:
            name = nodes[sid].name
            if name not in seen:
                dev[name] = dev.get(name, 0.0) + ms
                seen.add(name)
            sid = nodes[sid].parent

    threads: dict = {}
    for u in units:
        threads[nodes[u].thread] = threads.get(nodes[u].thread, 0) + 1
    main = max(threads, key=threads.get)
    main_line = _timeline([s for s in nodes.values() if s.thread == main])
    busy = _merge((op.start, op.end) for op in ops)
    edges = [a] + [x for iv in busy for x in iv] + [b]
    idle: dict = {}
    cuts = main_line[0]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        points = ([g0] + cuts[bisect.bisect_right(cuts, g0):
                              bisect.bisect_left(cuts, g1)] + [g1])
        for p0, p1 in zip(points, points[1:]):
            sid = _at(main_line, (p0 + p1) / 2)
            name = OUTSIDE if sid is None else nodes[sid].name
            idle[name] = idle.get(name, 0.0) + (p1 - p0) / 1e6

    counters: dict = {}
    for c in counts:
        if c.span is None or c.span in nodes:
            counters[c.name] = counters.get(c.name, 0) + c.n
    return Spans(units=len(units), count=count, host_ms=host, self_ms=own,
                 device_ms=dev, device_self_ms=dev_self, counters=counters,
                 kernels=kernels, kernels_in_units=in_units, idle_ms=idle)


def window(events, name: str) -> tuple | None:
    """(start, end) ns of the host annotation `name` among the profiler's
    kineto events; None without it."""
    for e in events:
        if e.name() == name and e.device_type().name == "CPU":
            return e.start_ns(), e.end_ns()
    return None


def program_spans(records, bounds: tuple) -> list:
    """The tracer's spans (`trace.Records`) that lie inside `bounds`, as
    `Span`s; their clock is the profiler's."""
    a, b = bounds
    return [Span(s.id, s.name, s.parent, s.unit, s.thread, s.start_ns,
                 s.end_ns)
            for s in records.spans if a <= s.start_ns and s.end_ns <= b]


def profiler_parts(events) -> tuple:
    """(launches, device operations) of the profiler's kineto events: the
    CUDA runtime and driver calls on the host, and the device's rows other
    than the annotations' own (`pb:`)."""
    launches, ops = [], []
    for e in events:
        name = e.name()
        if e.device_type().name == "CPU":
            if name.startswith(LAUNCH_PREFIXES):
                launches.append(Launch(e.correlation_id(), e.start_ns()))
        elif not name.startswith("pb:"):
            ops.append(DeviceOp(name, e.correlation_id(), e.start_ns(),
                                e.end_ns()))
    return launches, ops


def read(reading) -> Spans | None:
    """The program's spans in the traced window of `reading`, read once;
    None where the program has no tracer or recorded nothing there."""
    return reading.cached("program_spans", lambda: _read(reading))


def _read(reading) -> Spans | None:
    tracer = reading.tracer
    if tracer is None or tracer.prof is None:
        return None
    try:
        from contextgs_tpu_torch.utils import trace
    except ImportError:
        return None
    records = trace.take()
    events = tracer.prof.profiler.kineto_results.events()
    bounds = window(events, "pb:window")
    if bounds is None:
        return None
    launches, ops = profiler_parts(events)
    return analyse(program_spans(records, bounds), records.counts, launches,
                   ops, bounds)


def per_unit(reading, field: str, names, scale: float = 1.0):
    """The sum of `field` (a dict of `Spans`) over `names` a harness unit,
    times `scale`; None where the run gave none of them."""
    got = read(reading)
    if got is None or not reading.units:
        return None
    table = getattr(got, field)
    names = [names] if isinstance(names, str) else names
    if not any(n in table for n in names):
        return None
    return scale * sum(table.get(n, 0.0) for n in names) / reading.units


def sync_names(reading) -> list:
    """The names of the `sync/*` spans the run recorded."""
    got = read(reading)
    return [] if got is None else [n for n in got.count
                                   if n.startswith("sync/")]
