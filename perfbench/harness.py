"""The benchmark's harness: finds a cell's configuration, traffic mix and
metrics by their names in `BENCHMARK.json`, runs the mix's kind, reads the
metrics and prints the result's one JSON line.

Everything that belongs to one configuration, one mix or one metric is a
file of its own, found by name:

- `configs/<file>`: the configuration (the `file` of its entry);
- `traffic/<traffic>.json`: the mix's parameters; its `kind` names the
  general driver in `kinds/<kind>.py` that reads them;
- `metrics/<metric>.py`: what a metric wraps or keeps in the run and its
  arithmetic (`read(reading)`; `None` when the run gave it nothing to read).

A kind's `Job` makes the cell's inputs from the seed, runs the program
through set-up, warm-up and the timed window (`Window`), and afterwards
compares what the window produced with the plain reference (`checks`).
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "contextgs_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: list          # [(entry of BENCHMARK.json, module)], e2e first


@dataclass
class Window:
    """The timed window: perf_counter at its start and end, the units
    completed in it, and each unit's latency in seconds where a kind
    times them."""
    start: float
    end: float
    units: int
    latencies: list = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    setup_s: float = 0.0       # from the process's start to `start`

    @property
    def seconds(self) -> float:
        return self.end - self.start


def process_age() -> float:
    """Seconds since this process started, from /proc."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


# the process's start on the perf_counter clock: set-up runs from it to the
# first timed unit
PROCESS_START = time.perf_counter() - process_age()


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_module(name: str, bench_dir: Path = HERE):
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric {name!r} has no reader {path}")
    return load_module(path, f"perfbench_metric_{name.replace('.', '_')}")


def kind_module(kind: str):
    if not (HERE / "kinds" / f"{kind}.py").is_file():
        raise FileNotFoundError(f"no kind {kind!r} under {HERE / 'kinds'}")
    return importlib.import_module(f"perfbench.kinds.{kind}")


def _reports(metric: dict, cell: str) -> bool:
    """Whether `cell` reports `metric`: every cell reports `setup_s`; any
    other metric lists its cells under `workloads`."""
    return metric["name"] == "setup_s" or cell in metric["workloads"]


def load_cell(repo: Path, name: str, trace: bool) -> Cell:
    """The cell `name` of `repo`/BENCHMARK.json with its configuration,
    mix and the metrics it reports: the end-to-end ones, or with `trace`
    the per-layer ones, each file looked up under `repo`/perfbench."""
    repo = Path(repo)
    bench_dir = repo / "perfbench"
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((repo / conf["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    chosen = ([m for m in bench["per_layer"] if _reports(m, name)]
              if trace else e2e)
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                metrics=[(m, metric_module(m["name"], bench_dir))
                         for m in chosen])


@contextlib.contextmanager
def replaced(module, attr: str, wrap):
    original = getattr(module, attr)
    setattr(module, attr, wrap(original))
    try:
        yield original
    finally:
        setattr(module, attr, original)


def plant(stack: contextlib.ExitStack, faults: dict, names: list) -> None:
    """Plant each named fault of `faults` ({name: [(module, attribute,
    wrap)]}) in the program for the life of `stack`."""
    for name in names:
        for module, attr, wrap in faults[name]:
            stack.enter_context(replaced(importlib.import_module(module),
                                         attr, wrap))


class Tracer:
    """Spans, kept arguments and call shapes around the program's calls,
    and the profiler's device trace, over a traced window.

    Each metric module may declare `SPANS` (span name → (module, attr) or a
    list of them, timed by CUDA events around each call), `HOST_SPANS`
    (the same, timed by the host clock), `KEEP` (key → (module, attr): the
    arguments of every call are kept) and `SHAPES` (key → (module, attr):
    the shapes of every call's tensor arguments are kept). A kind adds
    `names`: spans that only name what the host does, for the idle gaps.
    Every span is also a profiler annotation `pb:<name>`. Nothing is
    recorded outside `active`."""

    def __init__(self, modules: list, names: dict, device):
        self.on_cuda = device.type == "cuda"
        self.device_spans: dict = {}
        self.host_spans: dict = {}
        self.keep: dict = {}
        self.shapes: dict = {}
        self.name_spans: dict = dict(names)
        for m in modules:
            for kind, store in (("SPANS", self.device_spans),
                                ("HOST_SPANS", self.host_spans),
                                ("KEEP", self.keep),
                                ("SHAPES", self.shapes)):
                for key, targets in getattr(m, kind, {}).items():
                    targets = targets if isinstance(targets, list) else [
                        targets]
                    store.setdefault(key, [])
                    store[key] += [t for t in targets if t not in store[key]]
        self.active = False
        self.events: dict = {k: [] for k in self.device_spans}
        self.host: dict = {k: 0.0 for k in self.host_spans}
        self.kept: dict = {k: [] for k in self.keep}
        self.shaped: dict = {k: [] for k in self.shapes}
        self.units = 0
        self.prof = None
        self._stack = contextlib.ExitStack()

    # -- wrappers ---------------------------------------------------------
    def _wrap(self, keys_device=(), keys_host=(), keys_keep=(),
              keys_shape=(), names=()):
        tracer = self
        spans = sorted(set(keys_device + keys_host + names))
        label = "pb:" + "+".join(spans) if spans else None

        def wrap(fn):
            def call(*args, **kw):
                if not tracer.active:
                    return fn(*args, **kw)
                for k in keys_keep:
                    tracer.kept[k].append((args, kw))
                for k in keys_shape:
                    tracer.shaped[k].append([tuple(a.shape) for a in args
                                             if isinstance(a, torch.Tensor)])
                timed = tracer.on_cuda and keys_device
                if timed:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                t0 = time.perf_counter()
                with (torch.profiler.record_function(label) if label
                      else contextlib.nullcontext()):
                    out = fn(*args, **kw)
                if timed:
                    end.record()
                seconds = time.perf_counter() - t0
                for k in keys_device:
                    tracer.events[k].append((start, end) if timed
                                            else seconds)
                for k in keys_host:
                    tracer.host[k] += seconds
                return out
            return call
        return wrap

    def __enter__(self):
        by_target: dict = {}
        for store, slot in ((self.device_spans, 0), (self.host_spans, 1),
                            (self.keep, 2), (self.shapes, 3),
                            (self.name_spans, 4)):
            for key, targets in store.items():
                for t in (targets if isinstance(targets, list)
                          else [targets]):
                    by_target.setdefault(tuple(t), ([], [], [], [], []))
                    by_target[tuple(t)][slot].append(key)
        for (path, attr), keys in by_target.items():
            self._stack.enter_context(replaced(
                importlib.import_module(path), attr,
                self._wrap(*(tuple(k) for k in keys))))
        return self

    def __exit__(self, *exc):
        self.stop()
        self._stack.close()
        return False

    # -- the traced window ------------------------------------------------
    def start(self):
        """Start the traced window (the profiler and the spans)."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.on_cuda:
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = profile(activities=acts)
        self.prof.start()
        self._window = torch.profiler.record_function("pb:window")
        self._window.__enter__()
        self.t0 = time.perf_counter()
        self.active = True

    def unit(self):
        if self.active:
            self.units += 1

    def stop(self):
        if not self.active:
            return
        if self.on_cuda:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.active = False
        self._window.__exit__(None, None, None)
        self.prof.stop()

    def reading(self, window: Window) -> "Reading":
        return Reading(self, window)


def _merge(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Reading:
    """What a metric reads: the window, the span totals, kept arguments and
    shapes, and the profiler's device operations (name, start µs, end µs)
    inside the traced window, with the host annotations around them."""

    def __init__(self, tracer: Tracer | None, window: Window):
        self.window = window
        self.tracer = tracer
        self.device_ops = []      # (name, start_us, end_us)
        self.annotations = []     # (name, start_us, end_us)
        self.window_us = None
        self._cache: dict = {}
        if tracer is None or tracer.prof is None:
            return
        from torch.autograd import DeviceType

        for e in tracer.prof.events():
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                # the annotations' own rows on the device's timeline span
                # the work launched inside them, and are no operation
                if not e.name.startswith("pb:"):
                    self.device_ops.append((e.name, tr.start, tr.end))
            elif e.name == "pb:window":
                self.window_us = (tr.start, tr.end)
            elif e.name.startswith("pb:"):
                self.annotations.append((e.name[3:], tr.start, tr.end))
        if self.window_us is not None:
            a, b = self.window_us
            self.device_ops = [(n, max(s, a), min(e, b))
                               for n, s, e in self.device_ops
                               if e > a and s < b]
        self.device_ops.sort(key=lambda x: x[1])

    @property
    def units(self) -> int:
        return self.tracer.units if self.tracer is not None else \
            self.window.units

    @property
    def window_s(self) -> float:
        if self.window_us is not None:
            return (self.window_us[1] - self.window_us[0]) / 1e6
        return self.tracer.t1 - self.tracer.t0

    def span_ms(self, key: str) -> float:
        """The span's total ms: CUDA events on the card, the host clock
        elsewhere."""
        return sum(ev[0].elapsed_time(ev[1]) if isinstance(ev, tuple)
                   else ev * 1e3 for ev in self.tracer.events[key])

    def host_s(self, key: str) -> float:
        return self.tracer.host[key]

    def kept(self, key: str) -> list:
        return self.tracer.kept[key]

    def shapes(self, key: str) -> list:
        return self.tracer.shaped[key]

    def kernels(self, name_part: str = "") -> list:
        """Device kernels (not copies or fills) whose name holds
        `name_part`, in order: (name, start µs, end µs)."""
        return [op for op in self.device_ops
                if not op[0].startswith(("Memcpy", "Memset"))
                and name_part in op[0]]

    def busy_s(self) -> float:
        return sum(e - s for s, e in _merge(
            (s, e) for _, s, e in self.device_ops)) / 1e6

    def cached(self, key: str, compute):
        if key not in self._cache:
            self._cache[key] = compute()
        return self._cache[key]

    def breakdown(self) -> dict:
        """The device operations that took most time and the longest idle
        gaps, each named by the innermost host annotation around it."""
        totals: dict = {}
        for n, s, e in self.device_ops:
            totals[n] = totals.get(n, 0.0) + (e - s) / 1e6
        ops = sorted(totals.items(), key=lambda x: -x[1])[:10]
        merged = _merge((s, e) for _, s, e in self.device_ops)
        a, b = self.window_us
        edges = [a] + [x for iv in merged for x in iv] + [b]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for s, e in gaps[:10]:
            mid = (s + e) / 2
            around = [x for x in self.annotations if x[1] <= mid <= x[2]]
            name = (min(around, key=lambda x: x[2] - x[1])[0] if around
                    else "window")
            named.append([name, (e - s) / 1e6])
        return {"device_ops": [[n[:120], v] for n, v in ops],
                "idle_gaps": named}


def device_info(device, trace_reading: Reading | None) -> dict:
    out = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}
    if trace_reading is not None:
        out["busy_s"] = trace_reading.busy_s()
        out["window_s"] = trace_reading.window_s
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device, job_hook=None) -> tuple:
    """Run `cell` once → (result dict, the checks {name: (value, limit)}).
    `job_hook(job)` may change the job before it runs (the tests plant
    faults so)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = kind_module(cell.traffic["kind"])
    job = kind.Job(cell.config, cell.traffic, seed, device)
    if job_hook is not None:
        job_hook(job)
    tracer = None
    if trace:
        tracer = Tracer([m for _, m in cell.metrics], job.NAME_SPANS, device)
    with tracer if tracer is not None else contextlib.nullcontext():
        window = job.run(seconds, tracer)
    if tracer is not None:
        window.attempted = tracer.units
    window.setup_s = window.start - PROCESS_START
    if window.latencies:
        lat = sorted(window.latencies)
        print(f"window: {window.units} units in {window.seconds:.3f} s; a "
              f"unit {lat[0]:.4f} / {lat[len(lat) // 2]:.4f} / {lat[-1]:.4f}"
              " s (least / median / most)", file=sys.stderr)
    reading = Reading(tracer, window)
    info = device_info(device, reading if trace else None)
    metrics = {}
    for entry, module in cell.metrics:
        value = module.read(reading)
        if value is None:
            continue
        if isinstance(value, float) and not math.isfinite(value):
            continue
        metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    breakdown = reading.breakdown() if trace else None
    del reading
    if tracer is not None:
        tracer.kept.clear()
        tracer.prof = None
    job.release()
    checks = job.checks()
    correct = all(v <= lim for v, lim in checks.values())
    result = {"correct": correct, "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks
