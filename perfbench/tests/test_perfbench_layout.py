"""BENCHMARK.json against the benchmark's contract, and its files found by
name: a configuration, a mix and a metric added as new files are taken
without an edit to a file that is there."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from perfbench import harness
from perfbench.tests.small import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = ([m["name"] for m in metrics] + CELLS
             + [c["name"] for c in BENCH["configs"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        for cell in m["workloads"]:
            assert cell in CELLS
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_e2e_and_a_layer(cell):
    e2e = [m["name"] for m, _ in harness.load_cell(REPO, cell, False).metrics]
    layers = harness.load_cell(REPO, cell, True).metrics
    assert "setup_s" in e2e and len(e2e) >= 2
    assert layers
    for entry, _ in layers:
        assert entry["moves"] in e2e


@pytest.mark.parametrize("cell", CELLS)
def test_configs_and_mixes_are_files_found_by_name(cell):
    loaded = harness.load_cell(REPO, cell, False)
    w = {x["name"]: x for x in BENCH["workloads"]}[cell]
    conf = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    assert conf["file"].startswith("perfbench/configs/")
    assert loaded.config == json.loads((REPO / conf["file"]).read_text())
    assert loaded.traffic == json.loads(
        (REPO / "perfbench" / "traffic" / f"{w['traffic']}.json")
        .read_text())
    assert (REPO / "perfbench" / "kinds"
            / f"{loaded.traffic['kind']}.py").is_file()


def test_reduced_keys_are_in_the_config_file():
    for conf in BENCH["configs"]:
        data = json.loads((REPO / conf["file"]).read_text())
        assert sorted(conf["reduced"]) == sorted(data["reduced"])
        for key in conf["reduced"]:
            assert key in data and not key.endswith(("_dim", "_rank"))


def test_new_files_are_taken_without_an_edit(tmp_path):
    """A new configuration, mix and metric, each a new file, and their
    entries in BENCHMARK.json: the harness takes them by name."""
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    config = json.loads((REPO / "perfbench/configs/mip360.json").read_text())
    (tmp_path / "perfbench/configs/mip360_1080p.json").write_text(
        json.dumps(dict(config, width=1920, height=1080)))
    serve = json.loads((REPO / "perfbench/traffic/serve.json").read_text())
    (tmp_path / "perfbench/traffic/serve-16.json").write_text(
        json.dumps(dict(serve, views=16)))
    (tmp_path / "perfbench/metrics/views_done.serve.py").write_text(
        "def read(r):\n    return r.units\n")
    bench["configs"].append(dict(bench["configs"][0], name="mip360_1080p",
                                 file="perfbench/configs/mip360_1080p.json"))
    bench["workloads"].append(dict(name="mip360_1080p-serve-16",
                                   config="mip360_1080p",
                                   traffic="serve-16", chips=1, why="test"))
    bench["per_layer"].append(dict(name="views_done.serve", unit="views",
                                   better="higher", source="program_counter",
                                   layer="device", moves="view_ms",
                                   workloads=["mip360_1080p-serve-16"]))
    for m in bench["end_to_end"]:
        if m["name"] in ("view_ms", "view_ms_p95"):
            m["workloads"].append("mip360_1080p-serve-16")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell(tmp_path, "mip360_1080p-serve-16", True)
    assert cell.config["width"] == 1920 and cell.traffic["views"] == 16
    assert [m["name"] for m, _ in cell.metrics] == ["views_done.serve"]
    assert cell.metrics[0][1].read(type("R", (), {"units": 7})()) == 7
    e2e = harness.load_cell(tmp_path, "mip360_1080p-serve-16", False)
    assert {m["name"] for m, _ in e2e.metrics} == {"view_ms", "view_ms_p95",
                                                   "setup_s"}


def test_a_missing_metric_file_is_refused(tmp_path):
    with pytest.raises(FileNotFoundError):
        harness.metric_module("no_such_metric", tmp_path)
