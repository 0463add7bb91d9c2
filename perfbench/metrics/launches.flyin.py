"""`launches.serve`'s reader (`launches.serve.py` beside this file), read
in the fly-in cell's traced window."""

from pathlib import Path

from perfbench.harness import load_module

_serve = load_module(Path(__file__).with_name("launches.serve.py"),
                     "perfbench_metric_launches_serve")
read = _serve.read
