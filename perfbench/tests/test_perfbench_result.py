"""The result's last line: its keys, the metrics each cell reports and the
numbers compared beside their limits, from small runs on the CPU."""

from __future__ import annotations

import json

import pytest

from perfbench.tests.small import run_small

CELLS = ["mip360-train-context", "mip360-serve", "tandt-decode"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line_keys(cell, trace):
    result, checks = run_small(cell, trace)
    line = json.loads(json.dumps(result))
    # the numbers compared come last, under a key of their own
    assert list(line) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in line["metrics"]
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["checks"]) == set(checks)
    for name, (value, limit) in checks.items():
        assert line["checks"][name] == {"value": value, "limit": limit}
