"""Cells of `BENCHMARK.json` cut to a size a CPU test can hold: a few
thousand anchors, 64x48 views, a four-view orbit."""

from __future__ import annotations

from pathlib import Path

import torch

from perfbench import harness

REPO = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
# a few threads a test process, so that parallel test workers do not stall
torch.set_num_threads(2)
SEED = 2 ** 31 + 11


def small_cell(name: str, trace: bool = False,
               repo: Path = REPO) -> harness.Cell:
    cell = harness.load_cell(repo, name, trace)
    decode = cell.traffic["kind"] == "decode"
    cell.config = dict(cell.config, anchors=600 if decode else 2000,
                       width=64, height=48)
    traffic = dict(cell.traffic)
    if traffic["kind"] == "train":
        traffic.update(views=4, init_points=64, trace_units=2)
    elif traffic["kind"] == "serve":
        traffic.update(views=4, checked_views=2, trace_units=4)
    cell.traffic = traffic
    return cell


def run_small(name: str, trace: bool = False, faults=(), seconds=2.0,
              seed: int = SEED) -> tuple:
    """(result, checks) of one small run on the CPU with `faults` planted
    in the program."""
    def hook(job):
        job.faults = list(faults)
    return harness.run_cell(small_cell(name, trace), seed, seconds, trace,
                            CPU, job_hook=hook)
