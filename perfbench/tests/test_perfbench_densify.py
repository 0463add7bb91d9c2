"""The anchor-growing cell `tandt-train-densify` on the CPU at a small size
(300 anchors in a pool of 4,864 slots, 64x48 views, a four-view orbit,
segments of one round): its entries in BENCHMARK.json, the plain
reference's agreement with the port, the traced run's metrics, and the
planted faults that the check has to catch."""

from __future__ import annotations

import json

import pytest

from perfbench import harness
from perfbench.kinds import densify as kind
from perfbench.tests.small import CPU, REPO, SEED

CELL = "tandt-train-densify"
METRICS = ["densify_ms.densify", "densify_device_ms.densify",
           "densify_syncs.densify", "stats_ms.densify",
           "idle_share.densify", "launches.densify", "mfu.densify"]
# on the CPU the port and the reference differ by the order of their
# float32 operations alone, and a round not at all
AGREE = {"loss_gap": 1e-6, "grad_gap": 1e-5, "change_gap_median": 1e-4,
         "stats_gap": 1e-5, "densify_off": 0}


def small_cell(trace: bool = False) -> harness.Cell:
    cell = harness.load_cell(REPO, CELL, trace)
    cell.config = dict(cell.config, anchors=300, width=64, height=48,
                       capacity_headroom=16.0)
    cell.traffic = dict(cell.traffic, views=4, init_points=64,
                        segment_steps=100, trace_units=4)
    return cell


def run_small(trace: bool = False, faults=()) -> tuple:
    def hook(job):
        job.faults = list(faults)
    return harness.run_cell(small_cell(trace), SEED, 1.0, trace, CPU,
                            job_hook=hook)


def test_entries_and_files():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert cell["chips"] == 1 and cell["config"] == "tandt-100k"
    e2e = harness.load_cell(REPO, CELL, False)
    assert [m["name"] for m, _ in e2e.metrics] == ["train_step_ms",
                                                   "setup_s"]
    traced = harness.load_cell(REPO, CELL, True)
    assert [m["name"] for m, _ in traced.metrics] == METRICS
    assert kind.capacity(e2e.config) == 400_000
    assert set(e2e.traffic["limits"]) == set(AGREE)
    assert set(e2e.traffic["limits_why"]) == set(AGREE)


def test_reference_agrees_with_the_port():
    result, checks = run_small()
    assert result["correct"]
    assert result["attempted"] == 100
    for name, (value, _) in checks.items():
        assert value <= AGREE[name], (name, value)


def test_traced_run_reads_the_round():
    # a reader of the program's spans that is not the round's reads first:
    # the round's readers still find the spans' nesting
    cell = small_cell(trace=True)
    cell.metrics.insert(0, ({"name": "syncs.train", "unit": "waits/step"},
                            harness.metric_module("syncs.train")))
    result, _ = harness.run_cell(cell, SEED, 1.0, True, CPU)
    assert result["correct"] and result["attempted"] == 4
    got = result["metrics"]
    # the CPU has no device trace: the device's metrics give nothing
    assert set(got) == {"syncs.train", "densify_ms.densify",
                        "densify_device_ms.densify",
                        "densify_syncs.densify", "stats_ms.densify",
                        "mfu.densify"}
    assert got["densify_syncs.densify"]["value"] == 19
    assert got["densify_ms.densify"]["value"] > 0


@pytest.mark.parametrize("fault", ["no_stats", "shallow_growth"])
def test_a_broken_round_is_not_correct(fault):
    result, checks = run_small(faults=[fault])
    assert result["correct"] is False, checks
