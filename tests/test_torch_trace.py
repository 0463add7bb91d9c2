"""The port's spans and counters (`utils/trace.py`) on the CPU: off without
a profiler; under `torch.profiler.profile()` one span tree a context-phase
training step, a decoded-scene view and a bitstream decode, with a `sync/*`
span around each call that waits for a card; no profiler row of the
program's own; outputs bit-equal either way. The benchmark's reader
(`perfbench/spans.py`) nests a span of another thread by time and puts the
spans on the profiler's clock."""

import copy
import statistics
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import profile, record_function

from contextgs_tpu_torch import config as tcfg
from contextgs_tpu_torch import evaluation as teval
from contextgs_tpu_torch.compression import codec as tcodec
from contextgs_tpu_torch.models.state import param_leaves
from contextgs_tpu_torch.scene.cameras import make_camera
from contextgs_tpu_torch.scene.dataset_readers import SceneInfo
from contextgs_tpu_torch.train import loop as tloop
from contextgs_tpu_torch.train.step import make_train_step
from contextgs_tpu_torch.utils import trace
from perfbench import spans as reader

torch.set_num_threads(1)

W, H = 48, 32
LAYERS = ("train/", "render/", "context/", "raster/", "sync/", "serve/",
          "codec/")
# the context step's tree: each span's children by name, with how many
STEP_TREE = {
    "train/step": {"train/levels": 1, "train/render": 1, "train/loss": 1,
                   "train/backward": 1, "train/stats": 1, "train/adam": 1},
    "train/levels": {"sync/quant.consts": 1, "sync/levels.scale": 2},
    "train/render": {"sync/camera": 1, "render/cull": 1,
                     "sync/render.visible": 1, "render/decode": 1,
                     "raster/project": 1, "raster/bin": 1,
                     "raster/blend": 1},
    "render/cull": {"sync/quant.consts": 1},
    "render/decode": {"sync/quant.consts": 1, "context/quantize": 1,
                      "context/rate": 1},
    "context/quantize": {"sync/context.level": 3},
    "raster/project": {"sync/raster.ndc_scale": 1},
    "raster/bin": {"sync/sort.demand": 1, "sync/sort.bins": 1},
    "train/loss": {"sync/ssim.window": 1},
    "train/backward": {"raster/blend_backward": 1},
}
# waits for a card a context step would make: the calls above, with the
# two constants of each anchor quantization and the bincount's two reads
STEP_SYNCS = 20


def _children(records) -> dict:
    """{span id: {child name: count}} and the roots."""
    kids: dict = {}
    for s in records.spans:
        if s.parent is not None:
            row = kids.setdefault(s.parent, {})
            row[s.name] = row.get(s.name, 0) + 1
    return kids


def _tree(records) -> dict:
    """{span name: {child name: count}} over the records, each name once."""
    kids = _children(records)
    out: dict = {}
    for s in records.spans:
        if s.id in kids:
            assert out.get(s.name, kids[s.id]) == kids[s.id], s.name
            out[s.name] = kids[s.id]
    return out


@pytest.fixture(scope="module")
def trained():
    """A tiny model trained into the context phase on the CPU, and its
    scene."""
    rng = np.random.default_rng(3)
    cams = []
    for i in range(3):
        ang = (i - 1) * 0.15
        r = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        cam = make_camera(i, r, np.zeros(3), 1.0, 1.0, W, H)
        cam.image = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        cams.append(cam)
    pts = np.stack([rng.uniform(-0.8, 0.8, 60), rng.uniform(-0.8, 0.8, 60),
                    rng.uniform(1.5, 5.0, 60)], 1).astype(np.float32)
    scene = SceneInfo(points=pts, colors=np.zeros_like(pts),
                      normals=np.zeros_like(pts), train_cameras=cams,
                      test_cameras=[], radius=2.0)
    cfg = tcfg.TrainConfig(
        model=tcfg.ModelConfig(feat_dim=8, n_offsets=4, voxel_size=0.05,
                               capacity_headroom=3.0),
        opt=tcfg.OptimizationConfig(iterations=6, noise_from=2,
                                    context_from=4),
        log_every=1000, save_iterations=())
    ts = tloop.train(cfg, scene, device="cpu")
    assert ts.level_scales
    trace.take()
    return cfg, scene, ts


def _step(trained):
    """A context step of the trained state on copies of it: (step, its
    arguments)."""
    cfg, scene, ts = trained
    cam = scene.train_cameras[0]
    step = make_train_step(cfg, W, H, "context", ts.spatial_lr_scale,
                           level_scales=ts.level_scales,
                           voxel_size=ts.voxel_size)
    params, buffers, adam = copy.deepcopy(
        (ts.model.params, ts.model.buffers, ts.adam))
    args = (params, buffers, adam,
            cam.as_device_dict(), tloop._to_image(cam, "cpu"),
            torch.zeros(3), 7, True, torch.Generator().manual_seed(5))
    return step, args


def _own_rows(prof) -> list:
    """Profiler rows named as the program names its spans."""
    return [e.name for e in prof.events() if e.name.startswith(LAYERS)]


def test_off_records_nothing(trained):
    """Without a profiler a span is the shared null context, a count does
    nothing, and a whole step records nothing."""
    assert trace.span("train/step") is trace.span("raster/bin")
    assert trace.sync("sort.demand", 2) is trace.span("x")
    trace.count("symbols", 5)
    step, args = _step(trained)
    step(*args)
    got = trace.take()
    assert got.spans == [] and got.counts == []


def test_train_step_spans(trained):
    """One context step under the profiler: one `train/step` root whose
    children are the layer spans, parents as named, a `sync/*` span
    around each call that waits for a card, and no profiler row of the
    program's own."""
    step, args = _step(trained)
    with profile() as prof:
        step(*args)
    got = trace.take()
    roots = [s for s in got.spans if s.parent is None]
    assert [s.name for s in roots] == ["train/step"]
    assert all(s.unit == roots[0].id for s in got.spans)
    assert _tree(got) == STEP_TREE
    # children lie inside their parents
    by_id = {s.id: s for s in got.spans}
    for s in got.spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    syncs = [c for c in got.counts if c.name == "syncs"]
    assert sum(c.n for c in syncs) == STEP_SYNCS
    assert all(by_id[c.span].name.startswith("sync/") for c in syncs)
    assert _own_rows(prof) == []


def test_view_and_decode_spans(trained, tmp_path):
    """A bitstream decode and a decoded-scene view under the profiler: one
    root each with its layer spans; `symbols` counts every decoded
    symbol."""
    cfg, scene, ts = trained
    tcodec.encode_scene(ts.model.params, ts.model.buffers, cfg.model,
                        ts.level_scales, ts.voxel_size, str(tmp_path))
    trace.take()
    with profile() as prof:
        dec = tcodec.decode_scene(str(tmp_path), cfg.model, device="cpu")
    got = trace.take()
    roots = [s for s in got.spans if s.parent is None]
    assert [s.name for s in roots] == ["codec/decode_scene"]
    tree = _tree(got)
    levels = cfg.model.level_num
    top = tree["codec/decode_scene"]
    assert set(top) == {"codec/load", "codec/hyper", "codec/masks",
                        "codec/context", "codec/predict", "codec/cdf",
                        "codec/coder"}
    assert top["codec/predict"] == levels
    # a CDF build and a range decode a stream chunk
    assert top["codec/cdf"] == top["codec/coder"] >= 3 * levels
    assert tree["codec/predict"] == {"sync/codec.params": 1}
    assert tree["codec/context"] == {"sync/levels.scale": levels - 1,
                                     "sync/codec.level": 1}
    n, f = dec.feat.shape
    symbols = sum(c.n for c in got.counts if c.name == "symbols")
    assert symbols == n * (f + 6) + 3 * int(dec.masks.sum())
    assert _own_rows(prof) == []

    render = teval.make_decoded_renderer(dec, cfg, W, H, device="cpu")
    cam = scene.train_cameras[1].as_device_dict()
    with profile() as prof:
        render(cam, np.zeros(3, np.float32))
    got = trace.take()
    assert [s.name for s in got.spans if s.parent is None] == ["serve/view"]
    assert _tree(got) == {
        "serve/view": {"sync/camera": 1, "render/cull": 1,
                       "sync/view.visible": 1, "render/decode": 1,
                       "raster/project": 1, "raster/bin": 1,
                       "raster/blend": 1},
        "raster/bin": {"sync/sort.demand": 1, "sync/sort.bins": 1}}
    assert sum(c.n for c in got.counts if c.name == "syncs") == 7
    assert _own_rows(prof) == []


def test_reader_nests_another_threads_span():
    """A span opened on another thread has no parent there; the reader
    nests it by time under the caller's span, so one unit remains and the
    caller's self time leaves it out."""
    def work():
        with trace.span("raster/blend_backward"):
            time.sleep(0.02)

    with profile():
        with trace.span("train/backward"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    got = trace.take()
    inner = [s for s in got.spans if s.name == "raster/blend_backward"]
    assert len(inner) == 1 and inner[0].parent is None
    spans = [reader.Span(s.id, s.name, s.parent, s.unit, s.thread,
                         s.start_ns, s.end_ns) for s in got.spans]
    lo = min(s.start for s in spans)
    hi = max(s.end for s in spans)
    read = reader.analyse(spans, got.counts, [], [], (lo, hi))
    assert read.units == 1
    assert read.self_ms["train/backward"] == pytest.approx(
        read.host_ms["train/backward"] - read.host_ms["raster/blend_backward"])


def test_reader_aligns_spans_with_the_profiler():
    """Read as the reader reads them, inside a window annotated in the
    trace, spans around an aten op lie within 50 µs of that op's interval
    in the profiler's trace (the median of nine)."""
    a = torch.randn(256, 256)
    with profile() as prof:
        with record_function("test/window"):
            for _ in range(9):
                with trace.span("test/mm"):
                    torch.mm(a, a)
    got = trace.take()
    events = prof.profiler.kineto_results.events()
    spans = reader.program_spans(got, reader.window(events, "test/window"))
    ops = [e for e in events if e.name() == "aten::mm"]
    assert len(ops) == len(spans) == len(got.spans) == 9
    gaps = [max(abs(s.start - e.start_ns()), abs(s.end - e.end_ns()))
            for s, e in zip(spans, ops)]
    assert statistics.median(gaps) < 50_000


def test_tracing_leaves_the_step_bit_equal(trained):
    """The same context step from the same state, traced and untraced,
    gives bit-equal parameters, moments, buffers and metrics."""
    outs = []
    for traced in (False, True):
        step, args = _step(trained)
        if traced:
            with profile():
                out = step(*args)
        else:
            out = step(*args)
        outs.append(out)
    trace.take()
    (p0, b0, a0, m0), (p1, b1, a1, m1) = outs
    l0, l1 = param_leaves(p0), param_leaves(p1)
    assert list(l0) == list(l1)
    for n in l0:
        assert torch.equal(l0[n], l1[n]), n
    for x, y in zip(b0, b1):
        assert torch.equal(x, y)
    for d0, d1 in ((a0.mu, a1.mu), (a0.nu, a1.nu)):
        assert all(torch.equal(d0[k], d1[k]) for k in d0)
    for x, y in zip(m0, m1):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
