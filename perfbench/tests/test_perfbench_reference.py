"""The plain reference agrees with the port on the CPU at a small size, and
a run with the timed path broken underneath comes out not correct: a step
that leaves its state unchanged, half the batch left out, an answer
altered where it is produced. (One chip: no exchange between chips to
leave out.)"""

from __future__ import annotations

import pytest

from perfbench.tests.small import run_small

# on the CPU the port and the reference (written apart from it) differ by
# the order of their float32 operations alone
AGREE = {"loss_gap": 1e-6, "grad_gap": 1e-5, "change_gap": 1e-3,
         "change_gap_median": 1e-4, "image_max_abs": 1e-5,
         "image_mean_abs": 1e-6, "views_missing": 0, "codes_off": 0,
         "symbol_gap": 1e-4}


@pytest.mark.parametrize("cell", ["mip360-train-context", "mip360-serve",
                                  "tandt-decode"])
def test_reference_agrees_with_the_port(cell):
    result, checks = run_small(cell)
    assert result["correct"]
    for name, (value, _) in checks.items():
        assert value <= AGREE[name], (name, value)


@pytest.mark.parametrize("cell, fault", [
    ("mip360-train-context", "unchanged_state"),
    ("mip360-train-context", "half_batch"),
    ("mip360-serve", "altered_answer"),
    ("tandt-decode", "altered_answer"),
])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    result, checks = run_small(cell, faults=[fault])
    assert result["correct"] is False, checks
