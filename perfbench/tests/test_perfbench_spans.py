"""The reader of the program's spans (`perfbench/spans.py`) on synthetic
records: self time, device time matched by correlation id, a span of
another thread nested by time, the idle split; and each metric read from
it gives None where its span or counter is missing."""

from __future__ import annotations

from typing import NamedTuple

import pytest

from perfbench import harness, spans
from perfbench.spans import DeviceOp, Launch, Span


class Count(NamedTuple):      # as the program's tracer keeps a count
    name: str
    span: int | None
    n: int


MS = 1_000_000
MAIN, AUTOGRAD = 11, 22
# one step [0, 100] ms: render [10, 40] (bin [20, 30] in it, a sync [25,
# 28] in that), backward [50, 90] with the blend's backward [60, 80] on
# autograd's thread, adam [92, 98]
SPANS = [
    Span(1, "train/step", None, 1, MAIN, 0, 100 * MS),
    Span(2, "train/render", 1, 1, MAIN, 10 * MS, 40 * MS),
    Span(3, "raster/bin", 2, 1, MAIN, 20 * MS, 30 * MS),
    Span(4, "sync/sort.demand", 3, 1, MAIN, 25 * MS, 28 * MS),
    Span(5, "train/backward", 1, 1, MAIN, 50 * MS, 90 * MS),
    Span(6, "raster/blend_backward", None, 6, AUTOGRAD, 60 * MS, 80 * MS),
    Span(7, "train/adam", 1, 1, MAIN, 92 * MS, 98 * MS),
]
COUNTS = [Count("syncs", 4, 1), Count("symbols", 3, 500)]
# kernels: one launched in bin, one in the sync, one on autograd's thread
# in the blend's backward, one in backward outside it, one in adam, one
# with no launch in the trace, and a copy
LAUNCHES = [Launch(101, 21 * MS), Launch(102, 26 * MS), Launch(103, 61 * MS),
            Launch(104, 85 * MS), Launch(105, 93 * MS), Launch(107, 3 * MS)]
OPS = [DeviceOp("k_bin", 101, 22 * MS, 24 * MS),
       DeviceOp("k_sync", 102, 26 * MS, 27 * MS),
       DeviceOp("K2", 103, 62 * MS, 72 * MS),
       DeviceOp("k_bwd", 104, 86 * MS, 89 * MS),
       DeviceOp("k_adam", 105, 94 * MS, 95 * MS),
       DeviceOp("k_lost", 106, 96 * MS, 97 * MS),
       DeviceOp("Memcpy DtoH (Device -> Pageable)", 107, 4 * MS, 5 * MS)]


def reading():
    return spans.analyse(SPANS, COUNTS, LAUNCHES, OPS, (0, 100 * MS))


def test_host_and_self_time():
    r = reading()
    assert r.units == 1
    assert r.count == {n: 1 for n in (s.name for s in SPANS)}
    assert r.host_ms["train/render"] == 30
    assert r.self_ms["train/render"] == 20
    assert r.self_ms["raster/bin"] == 7
    # the other thread's span nests by time under the step's backward
    assert r.self_ms["train/backward"] == 20
    assert r.self_ms["train/step"] == 100 - 30 - 40 - 6
    assert r.counters == {"syncs": 1, "symbols": 500}


def test_device_time_by_correlation():
    r = reading()
    assert r.device_self_ms == {"raster/bin": 2, "sync/sort.demand": 1,
                                "raster/blend_backward": 10,
                                "train/backward": 3, "train/adam": 1,
                                "train/step": 1}
    assert r.device_ms["train/render"] == 3
    assert r.device_ms["train/backward"] == 13
    assert r.device_ms["train/step"] == 18
    # six kernels, the copy left out; the unmatched one is in no unit
    assert (r.kernels, r.kernels_in_units) == (6, 5)


def test_idle_split():
    r = reading()
    busy = 2 + 1 + 10 + 3 + 1 + 1 + 1
    assert sum(r.idle_ms.values()) == pytest.approx(100 - busy)
    # idle while the host sat in the sync's wait, and in backward's own
    # time (the blend's backward is another thread's)
    assert r.idle_ms["sync/sort.demand"] == pytest.approx(2)
    assert r.idle_ms["train/backward"] == pytest.approx(40 - 10 - 3)
    # the step's own time, less the copy in it
    assert r.idle_ms["train/step"] == pytest.approx(100 - 30 - 40 - 6 - 1)
    assert spans.OUTSIDE not in r.idle_ms


def test_outside_spans():
    r = spans.analyse(SPANS[:1], [], [], [], (-50 * MS, 100 * MS))
    assert r.idle_ms == {spans.OUTSIDE: 50, "train/step": 100}


class Stub:
    """A reading whose program spans are given."""

    def __init__(self, got, units=1):
        self.got, self.units = got, units

    def cached(self, key, compute):
        return self.got


NEW = ["render_host_ms.train", "render_device_ms.train",
       "backward_host_ms.train", "backward_device_ms.train", "adam_ms.train",
       "sync_ms.train", "syncs.train", "raster_prep_host_ms.serve",
       "sync_ms.serve", "syncs.serve", "predict_s.decode",
       "cdf_us_per_symbol.decode"]


@pytest.mark.parametrize("name", NEW)
def test_metric_none_without_its_span(name):
    module = harness.metric_module(name)
    assert module.read(Stub(None)) is None
    empty = spans.analyse(SPANS[:1], [], [], [], (0, 100 * MS))
    assert module.read(Stub(empty)) is None


def test_metrics_read_their_spans():
    r = Stub(reading(), units=2)
    read = {n: harness.metric_module(n).read(r) for n in NEW}
    assert read["render_host_ms.train"] == 15
    assert read["backward_device_ms.train"] == 6.5
    assert read["adam_ms.train"] == 3
    assert read["sync_ms.train"] == 1.5
    assert read["syncs.train"] == 0.5
    assert read["raster_prep_host_ms.serve"] == 5
