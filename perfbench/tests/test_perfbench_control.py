"""The control of `correct` on the card: the reference put in the
program's place in TF32, a step below the float32 the configurations
state, has to come out not correct. A small size of each cell; the cell's
own size runs by `python3 perfbench/control.py`. TF32 exists on the card
only."""

from __future__ import annotations

import pytest
import torch

from perfbench import harness
from perfbench.tests.small import SEED, small_cell


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mip360-train-context", "mip360-serve",
                                  "tandt-decode"])
def test_control_in_tf32_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists on the card only")
    c = small_cell(cell)
    c.config = dict(c.config, anchors=20000, width=256, height=192)
    job = harness.kind_module(c.traffic["kind"]).Job(
        c.config, c.traffic, SEED, torch.device("cuda"))
    checks = job.checks(control=True)
    assert not all(v <= lim for v, lim in checks.values()), checks
