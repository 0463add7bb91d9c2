"""The benchmark's growing cells (`perfbench/kinds/grow.py`) on the CPU at a
small size, held to the plain reference (`perfbench/reference/grow.py`,
written from ContextGS's semantics, not from the port): a city of 1,500
anchors (`kinds/flyin.city`) in a 4x pool, 64x36 views on an 8-view lap
of the fly-in, resumed in the context phase across a round, and the cube
scene of `kinds/densify.py` (300 anchors in 1,280 slots) resumed in the
noise or the context phase, each through `train.loop.train`. The
checkpoint's statistics are those of 100 steps that pass the gradient
threshold on one offset in 20, so that the round at step 100 grows. Also:
the two counters the cells read, the planted faults, the pending camera
order and the traced metrics."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch
from torch.profiler import profile

from contextgs_tpu_torch import config as tcfg
from contextgs_tpu_torch.scene.cameras import make_camera
from contextgs_tpu_torch.train.optim import init_adam
from contextgs_tpu_torch.train.step import make_train_step
from contextgs_tpu_torch.utils import trace
from perfbench import harness, inputs, program
from perfbench.kinds import densify, grow
from perfbench.reference import model as md
from perfbench.reference import raster

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 41


def _json(path: str) -> dict:
    return json.loads((REPO / path).read_text())


CITY = dict(_json("perfbench/configs/bungeenerf-train.json"), anchors=1500,
            width=64, height=36)
CUBE = dict(_json("perfbench/configs/tandt-100k.json"), anchors=300,
            width=64, height=48)
# an 8-view lap of the fly-in: view 0 at the top, view 4 at street level
LAP = dict(_json("perfbench/traffic/train-context-densify.json"), views=8,
           fixed_views=[0, 4])
ORBIT = _json("perfbench/traffic/train-noise.json")
# four steps to the round at a multiple of 100, then a segment of five,
# whose last step is the first after a round
SHORT = dict(warmup_steps=4, segment_steps=5, trace_units=4)
CASES = {
    "city-context": (CITY, dict(LAP, start_iteration=12096,
                                trace_from=12097, checked_round=12100,
                                **SHORT)),
    # the checked round in the first segment, none in set-up
    "city-context-window": (CITY, dict(LAP, start_iteration=12096,
                                       trace_from=12097, checked_round=12100,
                                       **dict(SHORT, warmup_steps=3))),
    "cube-noise": (CUBE, dict(ORBIT, start_iteration=4096, trace_from=4097,
                              **SHORT)),
    "cube-context": (CUBE, dict(ORBIT, start_iteration=12096,
                                trace_from=12097, **SHORT,
                                limits=dict(ORBIT["limits"], levels_off=0))),
}


def _with_statistics(job):
    """Statistics of 100 steps in the checkpoint: every offset seen 100
    times, one in 20 past the gradient threshold, a tenth of the anchors
    under the opacity floor."""
    job._inputs()
    state = job.state
    g = torch.Generator().manual_seed(1)
    alive = state["alive"]
    n, k = state["offsets"].shape[:2]
    live = alive[:, None].float()
    high = torch.rand((n, k), generator=g) < 0.05
    state["offset_denom"] = 100.0 * live.expand(n, k).contiguous()
    state["offset_grad_accum"] = torch.where(high, 1.0, 1e-5) * 100.0 * live
    low = torch.rand(n, generator=g) < 0.1
    state["anchor_denom"] = 100.0 * alive.float()
    state["opacity_accum"] = torch.where(low, 0.0, 10.0) * alive.float()


def _run(case: str, faults=(), trace_run=False, metrics=()):
    """(result, checks, job) of a run of `case` with `faults` planted."""
    config, traffic = CASES[case]
    cell = harness.Cell(name=case, chips=1, config=config, traffic=traffic,
                        metrics=list(metrics))
    jobs = []

    def hook(job):
        _with_statistics(job)
        job.faults = list(faults)
        jobs.append(job)

    result, checks = harness.run_cell(cell, SEED, 0.001, trace_run, CPU,
                                      job_hook=hook)
    return result, checks, jobs[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_resumed_run_across_a_round_matches_the_reference(case):
    """Every check within the mix's limits: the first steps' loss,
    gradients, changes and statistics, the round on the program's own
    inputs (`densify_off` 0) and, in the context phase, the levels of the
    grown pool (`levels_off` 0); the round grew anchors."""
    result, checks, job = _run(case)
    assert result["correct"], checks
    assert checks["densify_off"][0] == 0
    if job.phase == "context":
        assert checks["levels_off"][0] == 0
    else:
        assert "levels_off" not in checks
    traffic = CASES[case][1]
    iteration, depth = job.captured["depths"][-1]
    assert iteration == job.captured["round"]["iteration"] == traffic.get(
        "checked_round", 4100 if job.phase == "noise" else 12100)
    assert sum(depth) == int(job.captured["round"]["grown"]) > 0
    assert len(job.rounds["setup"]) == (0 if case.endswith("window") else 1)
    if case.startswith("city"):
        # the city's ground is the lower bound: anchors grown under it are
        # clamped to the first code, by the program as by the reference
        assert job.captured["clamped"] > 0


@pytest.mark.parametrize("fault,case,number", [
    ("half_batch", "cube-noise", "loss_gap"),
    ("unchanged_state", "cube-noise", "change_gap_median"),
    ("no_stats", "cube-noise", "stats_gap"),
    ("shallow_growth", "cube-noise", "densify_off"),
    ("shallow_growth", "city-context-window", "densify_off"),
    ("stale_levels", "cube-context", "levels_off")])
def test_a_planted_fault_is_caught(fault, case, number):
    """Each fault of the kind, planted in the program, takes the number
    that its limit holds past that limit."""
    result, checks, _ = _run(case, faults=[fault])
    value, limit = checks[number]
    assert value > limit and not result["correct"]


def _step_inputs(case: str):
    """A pooled state of `case`'s scene as the program's (params, buffers)
    and its reference rows, the phase's step and a camera of its views."""
    config, traffic = CASES[case]
    job = grow.Job(config, traffic, SEED, CPU)
    job._inputs()
    params, buffers = program.params(job.state, job.nets, job.config, CPU)
    cfg = tcfg.TrainConfig(model=program.model_config(job.config))
    step = make_train_step(cfg, job.width, job.height, job.phase,
                           traffic["spatial_lr_scale"],
                           level_scales=job.scales or (),
                           voxel_size=job.mcfg.voxel_size)
    r, t, fx, fy = job.poses[1]
    cam = make_camera(1, r, t, fx, fy, job.width, job.height)
    return job, params, buffers, step, cam, (r, t, fx, fy)


@pytest.mark.parametrize("case", ["cube-noise", "cube-context"])
def test_the_counters_count_the_cull_and_the_pool_rows(case):
    """One step under the profiler: `render_visible_anchors` counts the
    anchors the reference's cull keeps, `context_rows` every slot of the
    pool, and the step waits for the device as often as before the
    counters (on the CPU the binning's chain waits twice)."""
    job, params, buffers, step, cam, pose = _step_inputs(case)
    gt = torch.rand((3, job.height, job.width),
                    generator=torch.Generator().manual_seed(2))
    trace.take()
    with profile():
        step(params, buffers, init_adam(params), cam.as_device_dict(), gt,
             torch.zeros(3), CASES[case][1]["start_iteration"] + 1, True,
             torch.Generator().manual_seed(3))
    counts: dict = {}
    for c in trace.take().counts:
        counts[c.name] = counts.get(c.name, 0) + c.n
    rows = job.state
    want = raster.visible(md.quantized_anchor(rows),
                          torch.exp(rows["scaling_log"])[:, :3],
                          raster.camera(*pose, CPU), job.width, job.height,
                          valid=rows["alive"]) & rows["alive"]
    assert counts["render_visible_anchors"] == int(want.sum()) > 0
    assert counts["context_rows"] == rows["alive"].shape[0] == \
        densify.capacity(job.config)
    # a context step's 20 are those `test_torch_trace` holds it to
    assert counts["syncs"] == {"cube-noise": 13, "cube-context": 20}[case]


def test_a_plain_step_counts_no_pool_rows():
    """The plain phase draws and quantizes nothing: no `context_rows`."""
    job, params, buffers, _, cam, _ = _step_inputs("cube-noise")
    step = make_train_step(tcfg.TrainConfig(model=program.model_config(
        job.config)), job.width, job.height, "plain", 4.4)
    trace.take()
    with profile():
        step(params, buffers, init_adam(params), cam.as_device_dict(),
             torch.zeros((3, job.height, job.width)), torch.zeros(3), 2001,
             True)
    names = {c.name for c in trace.take().counts}
    assert "render_visible_anchors" in names and "context_rows" not in names


def test_the_traced_metrics_read_the_window():
    """A traced context run across the round: the city cell's readers find
    the round, its growth, the context spans and the two counters."""
    cell = harness.load_cell(REPO, "bungeenerf-train-context-densify", True)
    result, _, job = _run("cube-context", trace_run=True,
                          metrics=cell.metrics)
    got = result["metrics"]
    assert got["anchors_grown.grow"]["value"] == job.rounds["setup"][0][0]
    assert got["densify_ms.grow"]["value"] > 0
    assert got["context_ms.train"]["value"] > 0
    assert got["adam_ms.train"]["value"] > 0
    assert 0 < got["visible_share.grow"]["value"] <= 1


def test_a_traced_run_checks_the_set_ups_round():
    """A traced run stops before a checked round that lies past set-up:
    it checks the set-up's last round, and the levels of the first step
    after that round's iteration in the traced segment."""
    config, traffic = CASES["city-context"]
    CASES["city-context-past"] = (config, dict(traffic, checked_round=12200))
    try:
        result, checks, job = _run("city-context-past", trace_run=True)
    finally:
        del CASES["city-context-past"]
    assert result["correct"], checks
    assert job.captured["round"]["iteration"] == 12100
    assert checks["densify_off"][0] == 0 == checks["levels_off"][0]
    assert "levels" in job.captured


def test_the_pending_order_puts_the_checked_views_first():
    """The loop pops the fixed views, then the drawn ones, then every
    other view once; a seed gives its order again."""
    views, order, state = grow.first_views(LAP, SEED)
    assert views[:2] == [0, 4] and len(views) == LAP["checked_steps"]
    assert sorted(order) == list(range(LAP["views"]))
    assert order[::-1][:len(views)] == views
    assert grow.first_views(LAP, SEED) == (views, order, state)
    other = grow.first_views(dict(ORBIT, checked_steps=3), SEED)[0]
    assert len(set(other)) == 3 and all(0 <= v < 32 for v in other)


def test_a_schedule_unlike_the_programs_is_refused():
    """A configuration whose phase boundaries differ from the program's
    defaults does not start."""
    config, traffic = CASES["cube-noise"]
    job = grow.Job(dict(config, context_from=9000), traffic, SEED, CPU)
    with pytest.raises(ValueError, match="context_from"):
        job._config("unused.pt", 4100)


def test_the_city_is_resumed_off_the_shown_one():
    """The resumed city is the shown one moved by `anchor_shift`, its
    bounds its own, every slot of its anchors alive; the voxel is the one
    set-up finds."""
    shown, resumed, voxel = grow.scenes(CITY, SEED, CPU)
    shift = torch.tensor(CITY["anchor_shift"])
    torch.testing.assert_close(resumed["anchor"] - shown["anchor"],
                               shift.expand_as(shown["anchor"]))
    lo, hi = md.anchor_bounds(resumed["anchor"], resumed["alive"])
    assert torch.equal(resumed["bound_min"], lo)
    assert torch.equal(resumed["bound_max"], hi)
    assert bool(shown["alive"].all()) and voxel > 0
    assert set(shown) == set(inputs.anchor_state(CUBE, SEED, CPU))
